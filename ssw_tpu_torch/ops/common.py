"""Shared helpers for the alignment kernels: profile building, padding
geometry, and mode (byte/word tier) metadata.

The batched formulation replaces the reference's striped SSE registers
(ref: src/ssw.c:163-188) with a dense per-read profile tensor
profile[b, c, j] = mat[c, read[b, j]] plus an extra *virtual* alphabet
letter whose substitution row/column is all zero; read padding and
out-of-range reference positions are encoded as that letter, which exactly
reproduces the reference's bias-padding semantics (padded lanes score 0
against everything and propagate values diagonally at no cost).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def extend_matrix(mat: np.ndarray) -> np.ndarray:
    """(n, n) -> (n+1, n+1) with a zero row/col for the virtual pad letter."""
    n = mat.shape[0]
    out = np.zeros((n + 1, n + 1), dtype=np.int32)
    out[:n, :n] = mat
    return out


def seg_len(read_len, word: bool):
    lanes = 8 if word else 16
    return (read_len + lanes - 1) // lanes


def pad_total(read_len, word: bool):
    """Number of DP rows the reference kernel actually computes: the read
    length rounded up to a whole number of SIMD lanes (ref: src/ssw.c:169)."""
    return seg_len(read_len, word) * (8 if word else 16)


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def bucket_size(x: int, base: int = 64) -> int:
    """Round up to a coarse static-shape bucket (power-of-two-ish ladder) so
    jit compilation caches are reused across nearby problem sizes."""
    x = max(x, 1)
    b = base
    while b < x:
        b *= 2
    # refine with quarter steps to cap padding waste at ~25%
    for frac in (b // 2, b * 5 // 8, b * 3 // 4, b * 7 // 8):
        if frac >= x and frac % base == 0:
            return frac
    return b


@dataclass
class BatchGeometry:
    """Static + per-read geometry for one padded read batch at one tier."""
    L: int                    # padded DP row count (static)
    read_len: np.ndarray      # (B,) true read lengths
    col_mask: np.ndarray      # (B, L) bool: rows included in column maxima
    seg_id: np.ndarray        # (B, L) int8: lane-block id (< 16) of each row
    seg_start: np.ndarray     # (B, L) bool: first row of a lane block


def batch_geometry(read_len: np.ndarray, L: int, word: bool) -> BatchGeometry:
    read_len = np.asarray(read_len, dtype=np.int32)
    j = np.arange(L, dtype=np.int32)[None, :]
    sl = seg_len(read_len, word)[:, None].astype(np.int32)
    pt = (sl * (8 if word else 16))
    col_mask = j < pt
    seg = np.minimum(j // np.maximum(sl, 1), (8 if word else 16) - 1)
    seg_start = (j % np.maximum(sl, 1) == 0) & (seg == j // np.maximum(sl, 1))
    # int8/bool on purpose: these ship host->device every batch and the
    # kernels upcast on device; lane-block ids are < 16
    return BatchGeometry(L, read_len, col_mask, seg.astype(np.int8), seg_start)


def build_profile(reads: np.ndarray, read_len: np.ndarray,
                  mat_ext: np.ndarray) -> np.ndarray:
    """profile[b, c, j] = mat_ext[c, reads[b, j]] with pads as the virtual
    letter.  reads: (B, L) int32 already padded with code n.

    int8 on purpose: substitution scores are int8 by contract
    (ref: src/ssw.h s_profile mat) and the profile is the largest
    host->device transfer per batch — the kernels upcast on device."""
    return np.ascontiguousarray(
        mat_ext[:, reads].transpose(1, 0, 2).astype(np.int8))


def pad_reads(reads: list[np.ndarray], L: int, pad_code: int) -> np.ndarray:
    B = len(reads)
    out = np.full((B, L), pad_code, dtype=np.int32)
    for b, r in enumerate(reads):
        out[b, : len(r)] = r
    return out


# --- lane packing (ops/pack.py; users: pipeline._leaf_prepare, the packed
# forward cuda_sw.forward_shared_packed and its plain version
# scan_sw.forward_shared_ref_packed) -----------------------------------------
#
# 200bp reads in an L=256 bucket leave 22% of the lanes as padding.
# Packing several reads into one kernel row as
# contiguous *slots* recovers that: each slot spans the read's tier-padded DP
# rows (pad_total), slot boundaries cut the h_diag/F dependency chains (the
# kernel's segmented scan + per-lane resets), and per-slot block maxima feed
# the streaming suboptimal scan.  Outputs are bit-identical per read to the
# unpacked kernel: within a slot the DP sees exactly the lanes an unpacked
# row would (ref semantics: src/ssw.c:169 pads reads to whole SIMD lanes and
# lets pad rows ride diagonals into maxColumn).


@dataclass
class PackPlan:
    """Assignment of reads to (row, slot) positions in a packed batch."""
    L: int                 # lanes per packed row (static)
    n_rows: int            # packed rows (padded to a multiple of 8)
    S: int                 # max slots per row (static)
    row: np.ndarray        # (B,) packed row of each read
    slot: np.ndarray       # (B,) slot index within the row
    off: np.ndarray        # (B,) first lane of the read's slot
    slot_len: np.ndarray   # (B,) tier-padded slot length (pad_total)

    @property
    def util(self) -> float:
        return float(self.slot_len.sum()) / max(self.n_rows * self.L, 1)


def pack_plan(slot_len: np.ndarray, L: int,
              max_slots: int = 64) -> PackPlan:
    """First-fit-decreasing pack of per-read padded DP row counts into rows
    of L lanes (deterministic: ties keep read order).  max_slots bounds the
    per-slot reduce cost inside the kernel."""
    slot_len = np.asarray(slot_len, dtype=np.int32)
    if slot_len.size and int(slot_len.max()) > L:
        raise ValueError(f"slot longer than the packed row: "
                         f"{int(slot_len.max())} > {L}")
    B = len(slot_len)
    order = np.argsort(-slot_len, kind="stable")
    row = np.zeros(B, np.int32)
    off = np.zeros(B, np.int32)
    slot = np.zeros(B, np.int32)
    # vectorized first-fit: this runs on the host critical path per batch,
    # so the per-read row search is one numpy argmax over open rows
    # (O(B*rows) in C) instead of a Python scan
    cap = max(B, 1)
    row_fill = np.zeros(cap, np.int64)
    row_slots = np.zeros(cap, np.int64)
    n_open = 0
    for r in order:
        ln = int(slot_len[r])
        fits = ((row_fill[:n_open] + ln <= L)
                & (row_slots[:n_open] < max_slots))
        i = int(np.argmax(fits)) if fits.any() else n_open
        if i == n_open:
            n_open += 1
        row[r] = i
        off[r] = row_fill[i]
        slot[r] = row_slots[i]
        row_fill[i] += ln
        row_slots[i] += 1
    n_rows = round_up(max(n_open, 1), 8)
    S = int(row_slots[:n_open].max()) if n_open else 1
    return PackPlan(L, n_rows, S, row, slot, off, slot_len)


def pack_codes(plan: PackPlan, reads_padded: np.ndarray,
               pad_code: int) -> np.ndarray:
    """Packed read-code rows (n_rows, L): each slot carries the read's codes
    plus its tier-rounding pad codes; row tails are pad."""
    out = np.full((plan.n_rows, plan.L), pad_code,
                  dtype=reads_padded.dtype)
    for r in range(len(plan.row)):
        ln = int(plan.slot_len[r])
        out[plan.row[r], plan.off[r]:plan.off[r] + ln] = \
            reads_padded[r, :ln]
    return out


def pack_tables(plan: PackPlan, read_len: np.ndarray):
    """Compact per-(row, slot) tables the device geometry builder consumes:
    slot offset, padded slot length, and true read length; empty slots get
    off = L (past every lane) and zero lengths."""
    so = np.full((plan.n_rows, plan.S), plan.L, np.int32)
    sl = np.zeros((plan.n_rows, plan.S), np.int32)
    rl = np.zeros((plan.n_rows, plan.S), np.int32)
    for r in range(len(plan.row)):
        so[plan.row[r], plan.slot[r]] = plan.off[r]
        sl[plan.row[r], plan.slot[r]] = plan.slot_len[r]
        rl[plan.row[r], plan.slot[r]] = read_len[r]
    return so, sl, rl
