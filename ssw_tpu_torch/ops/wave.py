"""Plain PyTorch model of the anti-diagonal wavefront kernels
(csrc/sw_wave.cuh, sw_wave_i32.cu, sw_wave_i16.cu, sw_wave_packed.cu,
sw_wave_perread.cu), in their order.

The kernels' plain twins in ops/scan_sw.py compute a whole column at a
time with prefix maxima; this model computes what the wavefront computes,
step by step, so that the CPU tests can hold the new design itself against
the JAX package: a warp of 32 lanes per read, lane t owning rows t*K ..
t*K+K-1 and computing column s - t at step s; F (and the quirk's G) as
row-sequential chains; H, F, G and the running column maxima handed from
lane t-1 to lane t between steps; the poison profile row outside the
target; per-lane best-hit trackers merged once after the last step; the
column maxima read off lane 31; for the per-read kernel, lane 31's walk
of the column maxima that finds the terminate column, the stop at the end
of the 8-step trip that found it, and the re-run up to that column when a
tracker rose past its best after it.  Vectorised over reads and lanes,
with Python loops over steps and rows, so it is for tests at small sizes
only.
With i16=True it also checks that every intermediate the int16 kernel
computes stays inside int16 (its packed adds wrap), with F entering lane 0
at -16384 as there.

The entry points take the plain twins' arguments and return their outputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ssw_tpu_torch.ops import pack, scan_sw

NEG = scan_sw.NEG
NEG16 = -(2 ** 14)   # the int16 kernel's F fill and dead-row offset
DEAD = -(2 ** 30)    # the int32 kernel's dead-row offset
POISON = -128        # the profile row of a column outside the target
UNROLL = 8           # steps per loop trip of the kernels
NONE = 2 ** 31 - 1   # no terminate column (yet)

_I32 = torch.int32


class _Range:
    """The int16 kernel's check: every value it adds stays inside int16."""

    def __init__(self, on):
        self.on = on

    def __call__(self, x):
        if self.on and (int(x.min()) < -2 ** 15 or int(x.max()) >= 2 ** 15):
            raise OverflowError("an int16 intermediate left int16")
        return x


@dataclass
class Run:
    """One pass of the wavefront: the warp's merged best hit (score, end
    column, -1 when the score is 0, end_read), the masked column maxima
    (B, R') of the columns run and the word channel's (or None), and lane
    31's terminate walk: the first column whose maximum equals term (NONE
    without one) and the running max of the maxima up to it."""
    score: torch.Tensor
    col: torch.Tensor
    row: torch.Tensor
    colmax: torch.Tensor
    wmax: torch.Tensor | None
    c_term: torch.Tensor
    g_term: torch.Tensor


def wave_rows(profile, ref, read_len, col_mask, gapO: int, gapE: int, *,
              valid_len: int | None = None, take=None, wmask=None,
              rst=None, i16: bool = False, term=None,
              stop: bool = False) -> Run:
    """The wavefront over reads of L = 32*K rows against one target (ref
    (R,)) or a window each (ref (B, R)).

    profile (B, n1, L), read_len (B,), col_mask (B, L) bool; valid_len:
    the steps stop after column valid_len - 1 (the packed kernel); take
    (R,) or (B, R) bool: the columns that may take a new best hit (default
    all); wmask (B, L) bool: the dual word channel's rows; rst (B, L) bool:
    the quirk's block starts (the G chain runs); term (B,): lane 31 looks
    for the first column whose maximum equals it, and with stop a read's
    trackers freeze after the 8-step trip in which it is found."""
    B, n1, L = profile.shape
    if L % 32:
        raise ValueError(f"L = {L}: a warp has 32 lanes")
    K = L // 32
    dev = profile.device
    R = int(ref.shape[-1]) if valid_len is None else min(int(valid_len),
                                                        int(ref.shape[-1]))
    rng = _Range(i16)
    neg = NEG16 if i16 else NEG
    dead = NEG16 if i16 else DEAD
    # [b][code][t][k], the poison row after the n1 codes
    prof = torch.cat([profile.to(_I32).view(B, n1, 32, K),
                      torch.full((B, 1, 32, K), POISON, dtype=_I32,
                                 device=dev)], dim=1)
    off = torch.where(col_mask.view(B, 32, K), 0, dead).to(_I32)
    woff = (None if wmask is None else
            torch.where(wmask.view(B, 32, K), 0, dead).to(_I32))
    rs = None if rst is None else rst.view(B, 32, K)
    row = torch.arange(L, dtype=_I32, device=dev).view(32, K)
    real = row[None] < read_len.to(_I32).view(B, 1, 1)
    codes = ref.to(torch.long)[..., :R].expand(B, R)
    takes = (torch.ones((B, R), dtype=torch.bool, device=dev) if take is None
             else take.to(torch.bool)[..., :R].expand(B, R))
    t = torch.arange(32, device=dev)
    bi = torch.arange(B, device=dev)[:, None]
    sh = scan_sw._shift_right

    H = torch.zeros((B, 32, K), dtype=_I32, device=dev)
    E = torch.zeros_like(H)
    z = torch.zeros((B, 32), dtype=_I32, device=dev)
    Fo, Go, co, wo, hlast, hd_pend = (z + neg, z + neg, z, z, z, z)
    v, vc, jr = z, z - 1, z + L
    colmax = torch.zeros((B, R), dtype=_I32, device=dev)
    wmax = None if wmask is None else torch.zeros_like(colmax)
    zb = torch.zeros(B, dtype=_I32, device=dev)
    c_term, g_term = zb + NONE, zb
    running = torch.ones(B, dtype=torch.bool, device=dev)
    for s in range(R + 31):
        c = s - t
        inside = (c >= 0) & (c < R)
        cc = c.clamp(0, max(R - 1, 0))
        code = torch.where(inside[None], codes[:, cc] if R else cc[None],
                           n1)                             # (B, 32)
        flag = inside[None] & (takes[:, cc] if R else inside[None])
        # hand-off from lane t - 1 (__shfl_up_sync; lane 0 the boundary):
        # its previous step was this lane's column
        Fin, cin, hn = sh(Fo, neg), sh(co, 0), sh(hlast, 0)
        Gin, win = sh(Go, neg), sh(wo, 0)
        hd, hd_pend = hd_pend, hn
        sub = prof[bi, code, t[None], :]                   # (B, 32, K)
        F, G = Fin, Gin
        mo, mw = z, z
        hdk = hd
        Hn, En = torch.empty_like(H), torch.empty_like(E)
        for k in range(K):
            e = E[:, :, k]
            ht = torch.maximum(rng(hdk + sub[:, :, k]), e).clamp_min(0)
            hdk = H[:, :, k]
            Hk = torch.maximum(ht, F)
            hg = rng(ht - gapO)
            F = torch.maximum(rng(F - gapE), hg)
            hfp = Hk
            if rs is not None:
                r = rs[:, :, k]
                hfp = torch.where(r, ht, torch.maximum(G, ht))
                G = torch.maximum(torch.where(r, neg, G) - gapE, hg)
            En[:, :, k] = torch.maximum(
                torch.maximum(rng(hfp - gapO), rng(e - gapE)),
                torch.zeros_like(e))
            Hn[:, :, k] = Hk
            mo = torch.maximum(rng(Hk + off[:, :, k]), mo)
            if woff is not None:
                mw = torch.maximum(rng(Hk + woff[:, :, k]), mw)
        H, E = Hn, En
        Fo, Go, hlast = F, G, H[:, :, K - 1]
        co = torch.maximum(cin, mo)
        wo = torch.maximum(win, mw)
        # each lane's tracker: (value, first column, lowest read row)
        up = flag & (mo > v) & running[:, None]
        if bool(up.any()):
            hit = (H == mo[:, :, None]) & real
            low = torch.where(hit, row[None], L).amin(dim=2)
            v = torch.where(up, mo, v)
            vc = torch.where(up, c[None, :].to(_I32), vc)
            jr = torch.where(up, low, jr)
        # lane 31 holds column s - 31 complete
        if s >= 31:
            colmax[:, s - 31] = co[:, 31]
            if wmax is not None:
                wmax[:, s - 31] = wo[:, 31]
            if term is not None:
                look = c_term == NONE
                g_term = torch.where(look, torch.maximum(g_term, co[:, 31]),
                                     g_term)
                c_term = torch.where(look & (co[:, 31] == term), s - 31,
                                     c_term)
        if stop and s % UNROLL == UNROLL - 2:  # the end of a trip
            running &= c_term == NONE
    # the warp's merge: max, then the lowest column, then the lowest row
    g = v.amax(dim=1)
    at = v == g[:, None]
    col = torch.where(at, vc, 2 ** 30).amin(dim=1)
    low = torch.where(at & (vc == col[:, None]), jr, L).amin(dim=1)
    rl = read_len.to(_I32)
    end_col = torch.where(g > 0, col, -1).to(_I32)
    end_read = torch.where((g > 0) & (low < L), low, rl - 1).to(_I32)
    return Run(g, end_col, end_read, colmax, wmax, c_term, g_term)


def quirk_rst(seg_id, seg_start, L: int, max_sub: int):
    """The quirk's block starts of the restarted G chain: row 0, seg_start
    and every row whose seg_id differs from the row above.  Raises outside
    the conditions under which the chain equals the column scan's prefix
    max biased by seg_id * SEG_BUMP (csrc/sw_wave_i32.cu): seg_id not
    decreasing along a row, seg_start only where seg_id changes, and L *
    max_sub <= SEG_BUMP (ops/cuda_sw.quirk_wave_exact)."""
    sid = seg_id.to(_I32)
    prev = scan_sw._shift_right(sid, -1)
    if bool((sid < prev).any()):
        raise ValueError("seg_id decreases along a row: the lane blocks "
                         "are not contiguous")
    if bool((seg_start.to(torch.bool) & (sid == prev)).any()):
        raise ValueError("seg_start where seg_id does not change")
    if L * max(max_sub, 0) > scan_sw.SEG_BUMP:
        raise ValueError(f"L * max_sub = {L * max_sub} > SEG_BUMP: an "
                         f"earlier lane block's source could win")
    return sid != prev


def forward_shared(profile, ref, read_len, col_mask, seg_id, seg_start,
                   gapO: int, gapE: int, quirk: bool = False,
                   blockmax: bool = False, valid_len: int | None = None,
                   wmask=None, idx=None, own=None, i16: bool = False):
    """scan_sw.forward_shared_ref's outputs as the int32 (sw_wave_i32) or,
    with i16, the int16 wavefront (sw_wave_i16, quirk off) computes them:
    base (int16 column maxima clipped to 32767), blockmax, dual (wmask) and
    the owned-column mode (idx, own); the quirk by the restarted G chain
    (quirk_rst)."""
    if quirk and i16:
        raise ValueError("the int16 wavefront runs with the quirk off")
    rst = (quirk_rst(seg_id, seg_start, profile.shape[2],
                     int(profile.max())) if quirk else None)
    run = wave_rows(profile, ref, read_len, col_mask, gapO, gapE, take=own,
                    wmask=wmask, rst=rst, i16=i16)
    col = run.col
    end_ref = col if idx is None else torch.where(
        col >= 0, idx.to(_I32)[col.clamp_min(0).long()], -1).to(_I32)
    if not blockmax:
        return (run.score, end_ref, run.row,
                run.colmax.clamp_max(32767).to(torch.int16))
    vl = int(ref.shape[0]) if valid_len is None else int(valid_len)
    bm = scan_sw.blockmax_reduce(run.colmax, vl)
    if wmask is not None:
        bm = torch.stack([bm, scan_sw.blockmax_reduce(run.wmax, vl)], dim=1)
    return run.score, end_ref, run.row, bm


def forward_shared_gated(profile, ref, idx, own, read_len, col_mask, seg_id,
                         seg_start, gapO: int, gapE: int,
                         quirk: bool = False, i16: bool = False):
    """scan_sw.forward_shared_ref_gated's outputs, as the wavefront's
    owned-column mode computes them."""
    return forward_shared(profile, ref, read_len, col_mask, seg_id,
                          seg_start, gapO, gapE, quirk, idx=idx, own=own,
                          i16=i16)


def forward_shared_packed(profile, ref, so, sl, rl_s, flat_idx, gapO: int,
                          gapE: int, max_sub: int | None = None,
                          valid_len: int | None = None, quirk: bool = False,
                          word: bool = False, dual: bool = False):
    """scan_sw.forward_shared_ref_packed's outputs, as the packed wavefront
    computes them: one warp per slot, cut out of its packed row into Lw =
    pack.packed_lanes(longest slot) rows (the virtual letter's zero scores
    past the slot), col_mask j < sl, the word channel j < min(sl,
    round_up(rl, 8)), the quirk's block starts at q(j) = min(j*nb/sl,
    nb - 1) changes; the steps stop at valid_len and the blocks past it are
    0."""
    if dual and quirk:
        raise ValueError("the dual tier needs the quirk off")
    if quirk:
        pack.check_quirk_span(pack.slot_max(sl), max_sub, gapO, gapE)
    n1, W = profile.shape[1:]
    S = int(so.shape[1])
    dev = profile.device
    R = int(ref.shape[0])
    vl = R if valid_len is None else min(int(valid_len), R)
    fi = flat_idx.to(dev).long()
    o, ln, rl = (x.to(dev).reshape(-1)[fi].to(_I32) for x in (so, sl, rl_s))
    Lw = pack.packed_lanes(int(ln.max()) if ln.numel() else 0)
    j = torch.arange(Lw, dtype=_I32, device=dev)[None, :]
    inside = j < ln[:, None]
    src = (o[:, None] + j).clamp(max=W - 1).long()
    prof = torch.gather(profile[fi // S], 2,
                        src[:, None, :].expand(-1, n1, -1))
    prof = torch.where(inside[:, None, :], prof, 0)
    rst = None
    if quirk:
        nb = 8 if word else 16
        q = (j * nb // ln.clamp_min(1)[:, None]).clamp(max=nb - 1)
        rst = (j == 0) | (q != torch.cat([q[:, :1] - 1, q[:, :-1]], dim=1))
    wm = (j < torch.minimum(ln, (rl + 7) // 8 * 8)[:, None]) if dual else None
    run = wave_rows(prof, ref, rl, inside, gapO, gapE, valid_len=vl,
                    wmask=wm, rst=rst)
    nblk = (R + scan_sw.BM - 1) // scan_sw.BM
    bm = _blocks(run.colmax, nblk)
    if dual:
        bm = torch.stack([bm, _blocks(run.wmax, nblk)], dim=1)
    return run.score, run.col, run.row, bm


def _blocks(colmax, nblk):
    """Block maxima of the columns run, zero for the blocks past them."""
    bm = scan_sw.blockmax_reduce(colmax, colmax.shape[1])
    pad = torch.zeros((bm.shape[0], nblk - bm.shape[1]), dtype=_I32,
                      device=bm.device)
    return torch.cat([bm, pad], dim=1)


def forward_perread(profile, refw, read_len, col_mask, seg_id, seg_start,
                    gapO: int, gapE: int, quirk: bool = True,
                    terminate=None, emit_maxcol: bool = False,
                    reruns: list | None = None):
    """scan_sw.forward_perread_ref's outputs as the per-read wavefront
    (sw_wave_perread) computes them: each read's window as its ring's
    codes; lane 31 finds the terminate column c_T and g_T, the running max
    of the column maxima up to it; without emit_maxcol a read stops at the
    end of the trip in which c_T is found; a read whose merged score is not
    g_T (a tracker rose past it after c_T) runs again with only the columns
    <= c_T taking a best hit.  reruns: a list the indices of those reads
    are appended to."""
    B, _, L = profile.shape
    W = int(refw.shape[1])
    rst = (quirk_rst(seg_id, seg_start, L, int(profile.max())) if quirk
           else None)
    term = (torch.full((B,), -1, dtype=_I32, device=profile.device)
            if terminate is None else terminate.to(_I32))
    run = wave_rows(profile, refw, read_len, col_mask, gapO, gapE, rst=rst,
                    term=term, stop=not emit_maxcol)
    score, col, row = run.score.clone(), run.col.clone(), run.row.clone()
    again = (run.score != run.g_term).nonzero().flatten()
    if again.numel():
        cols = torch.arange(W, device=profile.device)[None]
        take = cols <= run.c_term[again, None]
        sel = lambda x: None if x is None else x[again]
        re = wave_rows(profile[again], refw[again], read_len[again],
                       col_mask[again], gapO, gapE, take=take,
                       rst=sel(rst))
        score[again], col[again], row[again] = re.score, re.col, re.row
        if reruns is not None:
            reruns.extend(again.tolist())
    out = (score, col, row)
    return out + (run.colmax,) if emit_maxcol else out
