"""Lane packing: several reads per DP row, each in a contiguous slot of its
tier-padded length (common.pack_plan), on the streaming path.

The JAX package packs reads to fill its TPU kernel's lanes.  Here the
packed layout (packed profile rows (n_rows, n+1, W) plus the slot tables
so/sl/rl_s of common.pack_tables) is the input of forward_shared_packed
(ops/cuda_sw.py), whose plain version scan_sw.forward_shared_ref_packed runs
the packed rows themselves, with the JAX kernel's devices for keeping slots
apart:

  * the slot bias slot_id * PACK_BUMP, folded into the per-lane affine
    constants (dmg, gmd), so that a carry across a slot boundary lands far
    below every value of the slot it enters and is inert;
  * h_diag cut and F poisoned at slot starts, and the gap decay restarting
    at every slot's first lane (lane_off);
  * with the quirk, a second bias level qseg * QBUMP that segments the lane
    blocks inside a slot; exact while the slot-local value span stays under
    QBUMP (check_quirk_span).

pack_geometry and pack_reconstruct are the counterparts of the JAX
package's pallas_sw._pack_geometry and _pack_reconstruct, on tensors.
"""

from __future__ import annotations

import torch

from ssw_tpu_torch.ops import common

PACK_BUMP = 2 ** 17  # slot separation for packed rows: DP intermediates
                     # span < 2**16, so 2**17 keeps up to 2**14 slots
                     # strictly ordered inside int32
QBUMP = PACK_BUMP // 16  # sub-slot lane-block separation for the quirk's
                     # segmented scan: a slot has at most 16 lane blocks,
                     # so block biases stay inside one PACK_BUMP step

_I32 = torch.int32


def slot_max(sl) -> int:
    """The longest slot of the tables (a device sync for a CUDA tensor)."""
    t = torch.as_tensor(sl)
    return int(t.max()) if t.numel() else 0


def pack_bound(longest: int) -> int:
    """The longest slot rounded up to a power of two (the JAX kernel's
    static scan radius `pack_bound`)."""
    return 1 << (max(int(longest), 1) - 1).bit_length()


# register variants of the kernels' lanes per thread (csrc/sw_dp.cuh reg_k)
REG_K = (2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32)


def packed_lanes(longest: int) -> int:
    """Lanes per warp of the packed kernel: 32*K for the smallest register
    variant K that holds the longest slot (32*ceil past 1024 lanes)."""
    k = max(1, -(-int(longest) // 32))
    return 32 * next((r for r in REG_K if r >= k), k)


def quirk_span_ok(longest: int, max_sub: int, gapO: int, gapE: int) -> bool:
    """Whether the quirk's block bias separation QBUMP stays above the
    slot-local value span pack_bound*(max_sub+gapE)+gapO, with `longest`
    the longest slot."""
    return pack_bound(longest) * (max_sub + gapE) + gapO < QBUMP


def check_quirk_span(longest: int, max_sub, gapO: int, gapE: int):
    """Raise unless quirk_span_ok (the JAX package asserts the same)."""
    if max_sub is None:
        raise ValueError("packed quirk path needs max_sub")
    if not quirk_span_ok(longest, max_sub, gapO, gapE):
        raise ValueError("slot-local value span exceeds the quirk block bias "
                         "separation QBUMP")


# Stretches: the packed wavefront may run a read as P warps, warp p owning
# the target columns [p*C, min((p+1)*C, valid_len)) and starting its DP from
# zero state `halo` columns before them (warp 0 at column 0).  The halo
# columns never take a best hit nor feed a block maximum; the per-stretch
# best hits merge as the whole scan's tracker would (highest score, then
# lowest column, then lowest row).  This is the sharded path's owned-column
# rule (parallel/dist.py) inside one launch.
STRETCH_ALIGN = 256  # C and halo: whole blocks of the block maxima (BM)
# C >= STRETCH_HALOS * halo: the halo stays under 1/64 of a stretch's work
STRETCH_HALOS = 64
# Warps per SM a split launch aims for.  The Ion Torrent headline's five
# packed dual leaves alone, P swept (leaf_timing.py --ion; NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md §6): every leaf kept gaining past what its
# variant holds resident (16-36 warps per SM), since later blocks even out
# the SMs' tails: K = 4 (187 reads) 94.2 ms at 11 warps per SM, 85.6 at
# 45, 81.2 at 91; K = 6 (293) 196.4 at 18, 168.6 at 71; K = 14 (62) 89.0
# at 4, 71.1 at 15 (P = 33, the halo cap).  In the Ion cell, in turns: 969
# and 950 reads/s at 32, 1,014 and 1,004 at 64, 955 and 1,025 at the cap.
STRETCH_FILL = 64


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def stretch_halo(lanes: int, max_sub, gapO: int, gapE: int) -> int:
    """Warm-up columns after which a zero-state restart of the DP is exact
    for slots of up to `lanes` rows: pipeline._restart_margin's bound with
    max(mat) <= max_sub (None: the int8 bound 127), a chain moving down at
    most `lanes` rows and paying min(gapO, gapE) for every other column.
    Rounded up to whole blocks."""
    ms = max(127 if max_sub is None else int(max_sub), 1)
    g = max(min(int(gapO), int(gapE)), 1)
    w = int(lanes) * (1 + (ms + g - 1) // g) + 1
    return _round_up(common.bucket_size(w, 64) + int(lanes) + 256,
                     STRETCH_ALIGN)


def stretch_bounds(valid_len: int, P: int) -> tuple[int, int]:
    """(P, C) for at most P stretches over valid_len columns: C the columns
    per stretch in whole blocks, P lowered so that no stretch is empty."""
    vl = max(int(valid_len), 1)
    C = _round_up(-(-vl // max(int(P), 1)), STRETCH_ALIGN)
    return -(-vl // C), C


def stretch_rule(B: int, wpb: int, sms: int, valid_len: int,
                 halo: int) -> int:
    """Stretches per read of a packed wavefront launch of B reads in
    blocks of wpb warps: 1 without SMs (the CPU) or where the whole-target
    launch already has a block on each of the `sms` SMs; else the least P
    that brings B*P warps to STRETCH_FILL warps per SM, at most as many as
    keep C >= STRETCH_HALOS * halo.

    Why a launch with a block on every SM stays whole: such launches are
    the 1,024-read leaves of the cells with many leaves in flight, whose
    forwards overlap on other streams; split, a leaf's blocks take every
    SM and the other leaves' short kernels queue behind them (PERF.md
    §6)."""
    target = STRETCH_FILL * int(sms)
    if B <= 0 or -(-B // max(int(wpb), 1)) >= int(sms):
        return 1
    P = -(-target // B)
    P_max = max(1, int(valid_len) // (STRETCH_HALOS * int(halo)))
    return stretch_bounds(valid_len, min(P, P_max))[0]


def stretch_spans(valid_len: int, P: int, C: int, halo: int) -> list:
    """(first scanned column, first owned column, end) of each stretch."""
    out = []
    for p in range(P):
        own = p * C
        end = int(valid_len) if p == P - 1 else own + C
        out.append((max(own - halo, 0), own, end))
    return out


def pack_geometry(so, sl, rl, L: int, nb: int = 16):
    """Per-lane packed geometry from the (n_rows, S) slot tables: col_mask
    (lane inside a slot's tier-padded span), slot_id (row tails inherit the
    last slot; they are masked), slot_start, lane_off (offset within the
    slot, growing on past the last slot), qseg (the lane block within the
    slot for the quirk's segmented scan: nb = 16 byte tier / 8 word, each
    of sl/nb lanes) and wcol (the word-tier validity span inside byte-sized
    slots, for the dual-tier maxima).  All (n_rows, L)."""
    so, sl, rl = so.to(_I32), sl.to(_I32), rl.to(_I32)
    j = torch.arange(L, dtype=_I32, device=so.device)[None, None, :]
    o = so[:, :, None]
    inside = (j >= o) & (j < o + sl[:, :, None])
    col_mask = inside.any(dim=1)
    started = j >= o
    slot_id = (started.to(_I32).sum(dim=1) - 1).clamp_min(0).to(_I32)
    slot_start = (j == o).any(dim=1)
    off_here = torch.where(started, o, 0).amax(dim=1)
    lane_off = (j[0] - off_here).to(_I32)
    sl_here = torch.gather(sl, 1, slot_id.long())
    qseg = (lane_off * nb // sl_here.clamp_min(1)).clamp(0, nb - 1)
    rl_here = torch.gather(rl, 1, slot_id.long())
    wcol = col_mask & (lane_off < (rl_here + 7) // 8 * 8)
    return col_mask, slot_id, slot_start, lane_off, qseg.to(_I32), wcol


def pack_reconstruct(bv, bc, maxcol, slot_id, lane_off, rl_s, S: int,
                     dual: bool = False):
    """Per-slot outputs from per-lane (best value, first column) trackers:
    a slot's score is its lanes' largest value (floored at 0), end_ref the
    earliest first-attainment column among the lanes holding it, end_read
    the lowest such lane offset inside the read (else rl - 1).  maxcol is
    (n_rows, nblk * S2) with the block as the major axis (S2 = 2S when
    dual); returns (n_rows, S) tables and (n_rows, S2, nblk) block maxima."""
    Br, L = bv.shape
    bv32 = bv.to(_I32)
    m3 = slot_id[:, None, :] == torch.arange(S, dtype=_I32,
                                             device=bv.device)[None, :, None]
    gmax = torch.where(m3, bv32[:, None, :], -(2 ** 30)).amax(dim=2)
    gmax = gmax.clamp_min(0)
    pos = gmax > 0
    is_g = m3 & (bv32[:, None, :] == gmax[:, :, None]) & pos[:, :, None]
    end_ref = torch.where(is_g, bc.to(_I32)[:, None, :], 2 ** 30).amin(dim=2)
    end_ref = torch.where(pos, end_ref, -1)
    lo = lane_off[:, None, :]
    hit = (is_g & (bc[:, None, :] == end_ref[:, :, None])
           & (lo < rl_s.to(_I32)[:, :, None]))
    end_read = torch.where(hit, lo, L).amin(dim=2)
    end_read = torch.where(end_read == L, rl_s.to(_I32) - 1, end_read)
    S2 = 2 * S if dual else S
    nblk = maxcol.shape[1] // S2
    mc = maxcol.reshape(Br, nblk, S2).permute(0, 2, 1)
    return gmax.to(_I32), end_ref.to(_I32), end_read.to(_I32), mc


def gather_reads(gmax, end_ref, end_read, mc, flat_idx, S: int,
                 dual: bool = False):
    """Per-read outputs from the per-slot tables; flat_idx = row * S + slot.
    The block maxima come back (B, nblk), or (B, 2, nblk) when dual (byte
    channel, then word)."""
    fi = flat_idx.long()
    Br, S2, nblk = mc.shape
    if dual:
        row, slot = fi // S, fi % S
        flat = mc.reshape(Br * S2, nblk)
        mc_res = torch.stack([flat[row * S2 + slot],
                              flat[row * S2 + S + slot]], dim=1)
    else:
        mc_res = mc.reshape(Br * S, nblk)[fi]
    return (gmax.reshape(-1)[fi], end_ref.reshape(-1)[fi],
            end_read.reshape(-1)[fi], mc_res.contiguous())
