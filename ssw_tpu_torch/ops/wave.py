"""Plain PyTorch model of the anti-diagonal wavefront kernels
(csrc/sw_wave.cuh, sw_wave_i16.cu, sw_wave_packed.cu), in their order.

The kernels' plain twins in ops/scan_sw.py compute a whole column at a
time with prefix maxima; this model computes what the wavefront computes,
step by step, so that the CPU tests can hold the new design itself against
the JAX package: a warp of 32 lanes per read, lane t owning rows t*K ..
t*K+K-1 and computing column s - t at step s; F (and the quirk's G) as
row-sequential chains; H, F, G and the running column maxima handed from
lane t-1 to lane t between steps; the poison profile row outside the
target; per-lane best-hit trackers merged once after the last step; the
column maxima read off lane 31.  Vectorised over reads and lanes, with
Python loops over steps and rows, so it is for tests at small sizes only.
With i16=True it also checks that every intermediate the int16 kernel
computes stays inside int16 (its packed adds wrap), with F entering lane 0
at -16384 as there.

The entry points take the plain twins' arguments and return their outputs.
"""

from __future__ import annotations

import torch

from ssw_tpu_torch.ops import pack, scan_sw

NEG = scan_sw.NEG
NEG16 = -(2 ** 14)   # the int16 kernel's F fill and dead-row offset
DEAD = -(2 ** 30)    # the int32 kernel's dead-row offset
POISON = -128        # the profile row of a column outside the target

_I32 = torch.int32


class _Range:
    """The int16 kernel's check: every value it adds stays inside int16."""

    def __init__(self, on):
        self.on = on

    def __call__(self, x):
        if self.on and (int(x.min()) < -2 ** 15 or int(x.max()) >= 2 ** 15):
            raise OverflowError("an int16 intermediate left int16")
        return x


def wave_rows(profile, ref, read_len, col_mask, gapO: int, gapE: int, *,
              valid_len: int | None = None, take=None, wmask=None,
              rst=None, i16: bool = False):
    """The wavefront over reads of L = 32*K rows against one target.

    profile (B, n1, L), ref (R,) codes, read_len (B,), col_mask (B, L) bool;
    valid_len: the steps stop after column valid_len - 1 (the packed
    kernel); take (R,) bool: the columns that may take a new best hit
    (default all); wmask (B, L) bool: the dual word channel's rows; rst
    (B, L) bool: the quirk's block starts (the G chain runs).  Returns
    (score, end column (-1 when the score is 0), end_read, the masked column
    maxima (B, R') and the word channel's (B, R') or None), R' the columns
    run."""
    B, n1, L = profile.shape
    if L % 32:
        raise ValueError(f"L = {L}: a warp has 32 lanes")
    K = L // 32
    dev = profile.device
    R = int(ref.shape[0]) if valid_len is None else min(int(valid_len),
                                                       int(ref.shape[0]))
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
    codes = ref.to(torch.long)[:R]
    takes = (torch.ones(R, dtype=torch.bool, device=dev) if take is None
             else take.to(torch.bool)[:R])
    t = torch.arange(32, device=dev)
    sh = scan_sw._shift_right

    H = torch.zeros((B, 32, K), dtype=_I32, device=dev)
    E = torch.zeros_like(H)
    z = torch.zeros((B, 32), dtype=_I32, device=dev)
    Fo, Go, co, wo, hlast, hd_pend = (z + neg, z + neg, z, z, z, z)
    v, vc, jr = z, z - 1, z + L
    colmax = torch.zeros((B, R), dtype=_I32, device=dev)
    wmax = None if wmask is None else torch.zeros_like(colmax)
    for s in range(R + 31):
        c = s - t
        inside = (c >= 0) & (c < R)
        cc = c.clamp(0, max(R - 1, 0))
        code = torch.where(inside, codes[cc] if R else cc, n1)
        flag = inside & (takes[cc] if R else inside)
        # hand-off from lane t - 1 (__shfl_up_sync; lane 0 the boundary):
        # its previous step was this lane's column
        Fin, cin, hn = sh(Fo, neg), sh(co, 0), sh(hlast, 0)
        Gin, win = sh(Go, neg), sh(wo, 0)
        hd, hd_pend = hd_pend, hn
        sub = prof[:, code, t, :]                          # (B, 32, K)
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
        up = flag[None, :] & (mo > v)
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
    # the warp's merge: max, then the lowest column, then the lowest row
    g = v.amax(dim=1)
    at = v == g[:, None]
    col = torch.where(at, vc, 2 ** 30).amin(dim=1)
    low = torch.where(at & (vc == col[:, None]), jr, L).amin(dim=1)
    rl = read_len.to(_I32)
    score = g
    end_col = torch.where(g > 0, col, -1).to(_I32)
    end_read = torch.where((g > 0) & (low < L), low, rl - 1).to(_I32)
    return score, end_col, end_read, colmax, wmax


def forward_shared(profile, ref, read_len, col_mask, seg_id, seg_start,
                   gapO: int, gapE: int, quirk: bool = False,
                   blockmax: bool = False, valid_len: int | None = None,
                   wmask=None, idx=None, own=None, i16: bool = False):
    """scan_sw.forward_shared_ref's outputs (quirk off), as the int16
    wavefront computes them: base (int16 column maxima), blockmax,
    dual (wmask) and the owned-column mode (idx, own)."""
    if quirk:
        raise ValueError("the int16 wavefront runs with the quirk off")
    score, col, end_read, colmax, wmax = wave_rows(
        profile, ref, read_len, col_mask, gapO, gapE, take=own,
        wmask=wmask, i16=i16)
    end_ref = col if idx is None else torch.where(
        col >= 0, idx.to(_I32)[col.clamp_min(0).long()], -1).to(_I32)
    if not blockmax:
        return (score, end_ref, end_read,
                colmax.clamp_max(32767).to(torch.int16))
    vl = int(ref.shape[0]) if valid_len is None else int(valid_len)
    bm = scan_sw.blockmax_reduce(colmax, vl)
    if wmask is not None:
        bm = torch.stack([bm, scan_sw.blockmax_reduce(wmax, vl)], dim=1)
    return score, end_ref, end_read, bm


def forward_shared_gated(profile, ref, idx, own, read_len, col_mask, seg_id,
                         seg_start, gapO: int, gapE: int,
                         quirk: bool = False, i16: bool = False):
    """scan_sw.forward_shared_ref_gated's outputs, as the int16 wavefront's
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
    score, end_ref, end_read, colmax, wmax = wave_rows(
        prof, ref, rl, inside, gapO, gapE, valid_len=vl, wmask=wm, rst=rst)
    nblk = (R + scan_sw.BM - 1) // scan_sw.BM
    bm = _blocks(colmax, nblk)
    if dual:
        bm = torch.stack([bm, _blocks(wmax, nblk)], dim=1)
    return score, end_ref, end_read, bm


def _blocks(colmax, nblk):
    """Block maxima of the columns run, zero for the blocks past them."""
    bm = scan_sw.blockmax_reduce(colmax, colmax.shape[1])
    pad = torch.zeros((bm.shape[0], nblk - bm.shape[1]), dtype=_I32,
                      device=bm.device)
    return torch.cat([bm, pad], dim=1)
