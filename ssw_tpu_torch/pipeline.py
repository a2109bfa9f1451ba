"""Batch alignment pipeline: the ssw_align orchestration, batched, in
PyTorch with hand-written CUDA kernels for the DP.

Mirrors the reference flow (ref: src/ssw.c:855-977) for a whole read batch
against one target:

  1. forward pass, byte-tier geometry (all reads at once, one kernel launch)
  2. word-tier rerun of the subset whose score overflows the byte range
     (score + bias >= 255, ref: src/ssw.c:883-886)
  3. suboptimal-score scan outside the maskLen window (tier-aware edges):
     over the (B, R) per-column maxima, or, when streaming (see
     _use_streaming), from per-256-column block maxima and two bounded
     per-read window re-runs (ops/subopt.py), with no (B, R) buffer.  A
     streaming leaf may pack its reads (PACK, ops/pack.py) and take the
     dual tier (DUAL), whose one pass emits both tiers' block maxima and
     replaces step 2's re-run
  4. reverse pass on reversed read prefixes vs per-read reference windows to
     locate begin positions (ref: src/ssw.c:918-930); the window length is a
     provable bound on the alignment's reference span, so the batched
     static-shape pass is exact
  5. banded traceback + cigar verification on the host (ref: src/ssw.c:940-957)

Every entry point takes `device`: None means "cuda" and raises when no card
is present; the tests pass "cpu", where the kernels' plain PyTorch twins
(ops/scan_sw.py) run.  For gapO <= gapE the batched path falls back to the
bug-compatible striped oracle per pair (the reference's lazy-F early exit
is lossy there; see core/oracle.py).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from ssw_tpu_torch import profiling
from ssw_tpu_torch.core import oracle
from ssw_tpu_torch.core.encoding import matrix_bias
from ssw_tpu_torch.ops import common, cuda_sw, gate, pack, scan_sw, subopt
from ssw_tpu_torch.parallel import dist

# -- observability hook (profiling.py) --------------------------------------
# profiled(counter) routes a GcupsCounter: per-phase seconds, useful-cell
# counts, spans and counts (`syncs`: one per blocking device->host copy)
# from every call in the context (the module-level slot keeps every leaf
# of every call on one counter)
profiled = profiling.profiled
_phase = profiling.phase


def resolve_device(device=None) -> torch.device:
    """torch.device for an entry point: None means "cuda", and a CUDA
    device without a card raises (no silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ssw_tpu_torch runs on the CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions")
    return dev


_FIELDS = ("reads", "ref", "mat", "gapO", "gapE", "flag", "filters",
           "filterd", "mask_len", "score_size")


@dataclass
class BatchRequest:
    reads: list[np.ndarray]        # encoded reads (int codes < n)
    ref: np.ndarray                # encoded target
    mat: np.ndarray                # (n, n) substitution matrix
    gapO: int
    gapE: int
    flag: int = 0x0F
    filters: int = 0
    filterd: int = 2 ** 31 - 1
    mask_len: list[int] | int = 15
    score_size: int = 2

    @classmethod
    def from_fields(cls, obj) -> "BatchRequest":
        """Copy the request fields of any object that has them (e.g. a
        request of the JAX package) without importing its module."""
        return cls(**{f: getattr(obj, f) for f in _FIELDS})


def _as_masklen_array(mask_len, B):
    if isinstance(mask_len, (int, np.integer)):
        return np.full(B, int(mask_len), dtype=np.int32)
    return np.asarray(mask_len, dtype=np.int32)


def _window_len(max_read_len: int, ref_len: int, mat: np.ndarray,
                gapO: int, gapE: int) -> int:
    """Upper bound on the reference span of any positive-score alignment:
    span <= read_span * (1 + max(mat)/min(gapO,gapE)); used to size the
    reverse pass's static window."""
    max_sub = max(int(np.max(mat)), 1)
    g = max(min(gapO, gapE), 1)
    w = max_read_len * (1 + (max_sub + g - 1) // g) + 1
    return common.bucket_size(int(min(w, ref_len)), 64)


MIN_BUCKET = 64   # reads per length bucket before it earns its own shape
MAXCOL_BUDGET = 2 << 30  # bytes of per-column maxima per forward pass
MAXCOL_HARD_CAP = 3 << 30  # bound for one int16 maxcol buffer
# Lanes (rows x L) of one forward batch that the JAX package's splitting
# rules aim for; kept as a plain constant so the port splits batches (and
# so orders its stderr warnings) exactly as the reference package does.
OPT_LANES = 32768


def _restart_margin(L: int, mat: np.ndarray, gapO: int, gapE: int) -> int:
    """Columns of warm-up after which a zero-state DP restart is exact (see
    ops/subopt.py): a dependency chain either moves a lane up (at most L
    lane steps, including the zero-cost diagonal rides through padded
    rows/columns) or pays at least min(gapO, gapE) from a value bounded by
    L * max|mat|.  _window_len already bounds the pay-down span; add the
    full lane budget plus slack."""
    return _window_len(L, 1 << 30, mat, gapO, gapE) + L + 256


# Forces the suboptimal scan's path: None applies _use_streaming's rule,
# True/False stream always/never (the tests and chip_smoke.py set it).  The
# counterpart of the JAX package's SSW_TPU_STREAM_SUBOPT variable.
STREAM_SUBOPT: bool | None = None

# Target columns from which the port streams even when the (B, R) maxima
# buffer would fit.  From Rp = 2^20 on, the full scan's leaves are no larger
# than the streaming split's 1024 rows (2 GB of int16 maxima), so both run
# the same forward launches and streaming saves the (B, R) stores and the
# glue: config 4 (Rp = 1,048,576, 8192 reads, chip_smoke.py phase 5, runs
# in turns) took 5.370 and 5.591 s streaming against 5.973 and 5.890 s with
# the full scan on an NVIDIA H100 80GB HBM3 at 700 W, same SAM (PERF.md).
# Below it the full scan's leaves hold more rows (up to the CLI's 2048-read
# batch) than streaming's 1024, and the forward kernel is latency bound, so
# streaming would add forward launches there (not measured on the card).
# The JAX package's 524,288 was fitted on another chip.
STREAM_MIN_COLS = 1 << 20


def _sweet_rows(L: int) -> int:
    """Batch rows that fill OPT_LANES for bucket L."""
    return max(64, (OPT_LANES // max(L, 1)) // 64 * 64)


def _use_streaming(Rp_est: int, L_est: int) -> bool:
    """Stream the suboptimal scan (per-block maxima + bounded window
    re-runs) when holding (B, Rp) per-column maxima would force the leaf
    below its OPT_LANES rows (the JAX package's memory rule: chromosome-scale
    targets), or from STREAM_MIN_COLS target columns on.  Outputs do not
    depend on the choice; STREAM_SUBOPT forces either path."""
    if STREAM_SUBOPT is not None:
        return bool(STREAM_SUBOPT)
    if Rp_est >= STREAM_MIN_COLS:
        return True
    rows_cap = max(64, int(MAXCOL_HARD_CAP // (Rp_est * 2)) // 64 * 64)
    return rows_cap < _sweet_rows(L_est)


def _rows_per_leaf(Rp_est: int, L_est: int, streaming: bool) -> int:
    """Reads per leaf.  Non-streaming: cap the (B, Rp) int16 maxima buffer
    at MAXCOL_BUDGET, but keep OPT_LANES rows while one buffer stays under
    MAXCOL_HARD_CAP.  Streaming has no such buffer: max(1024, OPT_LANES
    rows), the JAX package's split (it decides the order of stderr
    warnings, which the reverse pass emits per leaf and tier)."""
    if streaming:
        return max(1024, _sweet_rows(L_est))
    b_mem = max(64, int(MAXCOL_BUDGET // (Rp_est * 2)) // 64 * 64)
    rows_cap = max(64, int(MAXCOL_HARD_CAP // (Rp_est * 2)) // 64 * 64)
    return max(b_mem, min(_sweet_rows(L_est), rows_cap))


def _length_groups(Ls: list[int]) -> list[list[int]]:
    """Group read indices by length bucket, merging under-populated buckets
    into the next-larger one.  Ascending walk; a group's L is the largest
    bucket it absorbed, so every read fits."""
    order = sorted(set(Ls))
    if len(order) <= 1:
        return [list(range(len(Ls)))]
    by_bucket = {L: [] for L in order}
    for i, l in enumerate(Ls):
        by_bucket[l].append(i)
    groups: list[list[int]] = []
    carry: list[int] = []
    for L in order:
        carry += by_bucket[L]
        if len(carry) >= MIN_BUCKET:
            groups.append(carry)
            carry = []
    if carry:
        groups.append(carry)
    return groups


def _to(dev, a, dtype=None):
    """Host array -> tensor on `dev`.  A CUDA upload goes through pinned
    memory without blocking: a blocking copy from pageable memory would
    synchronise the stream, and launch must queue its work without
    waiting for the device."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


# (id, pad_code, Rp, device) -> (np_ref, fp, tensor)
_REF_CACHE: "dict[tuple, tuple]" = {}
_REF_CACHE_CAP = 6  # strong refs: identity keys stay valid while cached


def _device_ref(ref_np: np.ndarray, pad_code: int, Rp: int, device):
    """Padded target (Rp,) int32, resident on `device`.  Cached by identity
    of the host array: the CLI re-enters align_batch per memory chunk /
    strand / length bucket with the SAME target array."""
    def fp(a):
        # cheap content fingerprint guarding against in-place mutation of a
        # cached host array between calls: ends + a sparse stride sample
        s = a[:: max(len(a) // 64, 1)]
        return (len(a), a[:8].tobytes(), a[-8:].tobytes(), s.tobytes())

    key = (id(ref_np), pad_code, Rp, str(device))
    ent = _REF_CACHE.get(key)
    if ent is not None:
        np0, fp0, dev = ent
        if np0 is ref_np and fp0 == fp(ref_np):
            return dev
    ref_padded = np.full(Rp, pad_code, dtype=np.int32)
    ref_padded[: len(ref_np)] = ref_np
    dev = _to(device, ref_padded)
    while len(_REF_CACHE) >= _REF_CACHE_CAP:
        _REF_CACHE.pop(next(iter(_REF_CACHE)))
    _REF_CACHE[key] = (ref_np, fp(ref_np), dev)
    return dev


class _StreamPool:
    """Streams of one device that no live leaf holds.  take() hands out a
    free stream, or makes one with `make` when every stream is held;
    give() returns a stream once its leaf's last download is done.  Its
    size follows the leaves in flight (no knob)."""

    def __init__(self, make):
        self.make, self.free = make, []

    def take(self):
        return self.free.pop() if self.free else self.make()

    def give(self, stream):
        self.free.append(stream)


_POOLS: "dict[str, _StreamPool]" = {}


def _leaf_stream(dev, ref_d):
    """A pool stream of `dev` for one leaf of the asynchronous path, ordered
    after the caller's stream (which uploaded the cached target ref_d) and
    recorded on ref_d, so that a _REF_CACHE eviction cannot hand the
    target's memory back while the leaf still reads it; None on the CPU.

    torch.cuda.Stream draws on torch's own pool of streams per device and
    recycles them past its size (32), so beyond that many leaves in flight
    two leaves may share a stream: their work then serialises, and stays
    ordered and exact."""
    if dev.type != "cuda":
        return None
    pool = _POOLS.get(str(dev))
    if pool is None:
        pool = _POOLS[str(dev)] = _StreamPool(
            lambda: torch.cuda.Stream(device=dev))
    stream = pool.take()
    stream.wait_stream(torch.cuda.current_stream(dev))
    ref_d.record_stream(stream)
    profiling.count("leaf_streams")
    return stream


def _prep_core(reads_padded, read_len, mat_ext, col_word, seg_rows, L: int):
    """Profile and batch geometry on the device from the read codes.

    reads_padded (B, L) int8, read_len (B,) int32, mat_ext (n+1, n+1) int8,
    col_word / seg_rows (B,) bool: the per-read tier of col_mask and of the
    lane-block geometry.  Returns profile (B, n+1, L) int8
    (profile[b, c, j] = mat_ext[c, read[b, j]]), col_mask (B, L) bool,
    seg_id (B, L) int8, seg_start (B, L) bool."""
    profile = mat_ext[:, reads_padded.long()].permute(1, 0, 2).contiguous()
    j = torch.arange(L, dtype=torch.int32, device=read_len.device)[None, :]
    rl = read_len[:, None]

    def tier(word_rows):
        lanes = torch.where(word_rows[:, None], 8, 16).to(torch.int32)
        return lanes, (rl + lanes - 1) // lanes

    lanes_c, sl_c = tier(col_word)
    col_mask = j < sl_c * lanes_c
    lanes_s, sl_raw = tier(seg_rows)
    sl = sl_raw.clamp_min(1)
    seg_div = j // sl
    seg = torch.minimum(seg_div, lanes_s - 1)
    seg_start = (j % sl == 0) & (seg == seg_div)
    return profile, col_mask, seg.to(torch.int8), seg_start


def _prep_device(reads_i8, read_len, mat_ext, col_word, L: int,
                 seg_word: bool):
    """_prep_core with one seg tier for the whole batch (the quirk path,
    the only one where seg geometry matters, never speculates)."""
    seg_rows = torch.full(read_len.shape, bool(seg_word), dtype=torch.bool,
                          device=read_len.device)
    return _prep_core(reads_i8, read_len, mat_ext, col_word, seg_rows, L)


# Lane packing (ops/pack.py) on the streaming path: several reads per DP
# row, each in a slot of its tier-padded length.  PACK forces it: None
# applies _pack_rule (the H100's), True the JAX package's planner
# _plan_pack (it may still find no plan worth making), False never packs;
# the counterpart of the JAX package's SSW_TPU_PACK.  PACK_L pins the
# planner's row width (0: sweep PACK_WIDTHS), the counterpart of
# SSW_TPU_PACK_L.  Outputs do not depend on either.
PACK: bool | None = None
PACK_L = 0
PACK_WIDTHS = (1024, 2048, 4096)

# The dual tier on the streaming path: one forward pass with byte-tier row
# masks emits both tiers' block maxima, so no read re-runs to fix them.
# None applies the JAX package's rule (a streaming leaf with the quirk off
# where some read might overflow the byte tier); False never takes it (the
# re-run route of the JAX package's scan backend).  Outputs do not depend
# on it.
DUAL: bool | None = None


# The bounded-radius gate (ops/gate.py) on the forward launches.  GATE
# chooses its thresholds: None is the card's rule, which gates no launch;
# True the JAX package's gate_plan (its Pallas path, SSW_TPU_GATESCAN as
# gate.GATESCAN says), "tiers" the card's tiers (gate.card_thresholds) on
# every launch, False never gates.  Outputs do not depend on it.
#
# Why the card's rule gates nothing: the gate drops steps of the warp
# scan, which only the column-scan bodies have, so a gated launch runs the
# column-scan design, and every ungated launch runs the anti-diagonal
# wavefront, which has no scan to drop.  Gated scan against the ungated
# wavefront in turns on one card (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md §6; chip_smoke.py phase 6, leaf_timing.py): int16 and packed,
# the Ion Torrent headline at -m1 -x3 -o5 -e2 6.443 / 6.378 s gated
# against 3.175 s, the gated leaves 2.2-3.0x the wavefront's; int32, the
# Ion Torrent x20 leaves of phase 5c 1,759.37 against 867.56 ms (dual)
# and 1,454.09 against 704.58 ms (blockmax), the config-4 blockmax leaf
# 267.38 ms with the card's tiers and 186.53 ms with every column forced
# to depth 0 (the most the gate can save) against 99.15 ms.
GATE: bool | str | None = None


def _gate(L: int, gapO: int, gapE: int, max_sub: int,
          slot_max: int | None = None):
    """Thresholds for a forward launch over rows of L lanes (packed: rows
    of L lanes whose longest slot is slot_max, one warp of
    pack.packed_lanes(slot_max) lanes per slot), or None."""
    if GATE is None or GATE is False:
        return None
    if slot_max is None:
        K, span, bound = L // 32, L, None
    else:
        K = pack.packed_lanes(slot_max) // 32
        span, bound = slot_max, pack.pack_bound(slot_max)
    if GATE == "tiers":
        return gate.card_thresholds(K, span, gapO, gapE, max_sub)
    return gate.plan_thresholds(K, L, gapO, gapE, max_sub, bound)


def _slot_len(read_len, col_word):
    """Each read's slot length: its length padded to the tier's stripe (8
    lanes word, 16 byte)."""
    return np.where(col_word, (read_len + 7) // 8 * 8,
                    (read_len + 15) // 16 * 16).astype(np.int32)


def _plan_pack(read_len, col_word, Bp: int, L: int):
    """The JAX package's planner: a pack plan when the packed layout's lane
    utilisation beats the unpacked one by more than its TPU kernel's op
    overhead (+1 of ~32 vector ops per column for the slot-start h_diag
    cut, S/256-amortised slot reduces, a flat 2 % for the per-slot
    reconstruction), at the best of PACK_WIDTHS (or PACK_L); else None."""
    slot_len = _slot_len(read_len, col_word)
    best, best_eff = None, 0.0
    for W in (PACK_L,) if PACK_L else PACK_WIDTHS:
        if int(slot_len.max()) > W // 2:
            continue
        plan = common.pack_plan(slot_len, W)
        overhead = (33.0 + plan.S * 5.0 / 256.0) / 32.0 + 0.02
        eff = plan.util / overhead
        if eff > best_eff:
            best, best_eff = plan, eff
    unpacked_util = float(slot_len.sum()) / max(Bp * L, 1)
    if best is None or best_eff <= unpacked_util:
        return None
    return best


def _pack_rule(read_len, col_word, Bp: int, L: int):
    """PACK = None on the H100: pack every streaming leaf, at the narrowest
    of PACK_WIDTHS (or PACK_L) that holds two of its longest slots.

    The packed kernel runs one warp per slot (csrc/sw_wave_packed.cu),
    so lane utilisation, which the JAX planner weighs, costs nothing here;
    what differs is that a packed read runs the int32 kernel at its slot's
    width and stops at the target's last real column.  On the wavefront,
    in turns on the same reads (chip_smoke.py phase 6; NVIDIA H100 80GB
    HBM3, 700.00 W; PERF.md), the packed leaf took 89.96 ms against
    111.45 ms for the unpacked int16 blockmax leaf (config 4: 1024 x
    100 bp, 2^20 columns) and 486.35 ms against 733.06 ms for the unpacked
    int16 dual leaf (the Ion Torrent L = 192 group: 293 reads, 5,242,880
    columns).  The width (tools/sweep_boundaries.py packw, chip_smoke.py
    phase 9d, same card): 2048 reads against 2^20 columns took 0.273,
    0.277, 0.283 and 0.270 s at 100 bp with the rule's choice (1024) and
    PACK_L 1024, 2048, 4096, and 0.475, 0.480, 0.481 and 0.588 s at
    200 bp."""
    slot_len = _slot_len(read_len, col_word)
    for W in (PACK_L,) if PACK_L else PACK_WIDTHS:
        if int(slot_len.max()) <= W // 2:
            return common.pack_plan(slot_len, W)
    return None


def _word_mask(read_len, L: int):
    """Word-tier row validity (B, L) bool (8-lane stripe padding), the
    dual tier's wmask; col_mask then carries the byte-tier superset."""
    j = torch.arange(L, dtype=torch.int32, device=read_len.device)[None, :]
    return j < (read_len[:, None] + 7) // 8 * 8


def _prep_packed(codes, mat_ext):
    """Packed profile (n_rows, n+1, W) int8 on the device from the packed
    read codes (n_rows, W) int8."""
    return mat_ext[:, codes.long()].permute(1, 0, 2).contiguous()


def _might_overflow(read_len, score_size: int, quirk: bool, max_sub: int,
                    bias: int) -> np.ndarray:
    """(B,) bool: the reads whose largest possible score (read_len *
    max|mat| + bias) could reach 255 under score_size 2, quirk off; all
    False with the quirk or another score_size."""
    if score_size != 2 or quirk:
        return np.zeros(len(read_len), dtype=bool)
    return read_len.astype(np.int64) * max_sub + bias >= 255


def _dual_tier(might, streaming: bool) -> bool:
    """The dual tier (streaming, quirk off): one pass with byte-tier row
    masks emits both tiers' block maxima, and mid selects each read's final
    tier's channel instead of re-running might-but-didn't reads (might is
    all False with the quirk or a word-tier request)."""
    return bool(streaming and DUAL is not False and might.any())


def _final_tiers(st, score, might, rerun):
    """The byte/word tier rule on the forward's scores (ref:
    src/ssw.c:883-886): under score_size 2 a read whose score + bias
    reaches 255 takes the word tier.  Reads whose first-pass row mask does
    not match their final tier re-run to fix maxColumn (score and ends are
    already exact): quirk on, the word-tier reads with word geometry (the
    quirk makes the whole DP tier-dependent); quirk off, the
    might-but-didn't reads with byte rows, unless the dual tier emitted both
    tiers' maxima.  rerun(idx, word) is the caller's own re-run of reads
    idx, which writes their results into score and its other arrays.
    Returns each read's final tier and the scores, word-tier ones clamped
    to the reference word kernel's ceiling, 32,767 (_mm_adds_epi16;
    positions beyond saturation are undefined in the reference too)."""
    word = np.full(len(score), st.word_tier)
    if st.req.score_size == 2:
        need_word = score + st.bias >= 255
        word[need_word] = True
        redo = need_word if st.quirk else might & ~need_word
        if not st.dual and redo.any():
            rerun(np.nonzero(redo)[0], bool(st.quirk))
    return word, np.where(word, np.minimum(score, 32767), score)


def _packed_inputs(plan, reads_padded, read_len, B: int, pad_code: int,
                   mat_ext_d):
    """The packed forward launch's read-side inputs on mat_ext_d's device,
    for the first B reads of the batch that `plan` packs (reads_padded,
    read_len over that batch): the packed profile and the slot tables (so,
    sl, rl_s, flat_idx)."""
    dev = mat_ext_d.device
    so, sl, rl_s = common.pack_tables(plan, read_len)
    pprof = _prep_packed(
        _to(dev, common.pack_codes(plan, reads_padded, pad_code),
            torch.int8), mat_ext_d)
    fi = (plan.row * plan.S + plan.slot)[:B].astype(np.int32)
    return pprof, tuple(_to(dev, a) for a in (so, sl, rl_s, fi))


def _packed_forward(plan, pprof, ref_codes, tables, gapO: int, gapE: int,
                    max_sub: int, valid_len: int, quirk: bool, word: bool,
                    dual: bool):
    """The streaming leaf's one packed forward launch, with the gate the
    rule gives the plan's longest slot."""
    slot_max = int(plan.slot_len.max())
    return cuda_sw.forward_shared_packed(
        pprof, ref_codes, *tables, gapO, gapE, max_sub=max_sub,
        valid_len=valid_len, quirk=quirk, word=word, dual=dual,
        slot_max=slot_max, gate=_gate(plan.L, gapO, gapE, max_sub, slot_max))


def needs_quirk(mat: np.ndarray, gapE: int) -> bool:
    """The lane-block E quirk is observable only when an adjacent
    insertion+deletion can beat the substitution it replaces, i.e. when
    min(mat) < -2*gapE (see core/oracle.py)."""
    return int(np.min(mat)) < -2 * gapE


def _lane_bucket(max_len) -> int:
    """The lane bucket L of reads of at most max_len codes: the byte tier's
    padded length, bucketed to 64.  A read's own bucket groups it
    (_length_groups); a leaf's, that of its longest read, is its rows'
    width."""
    return common.bucket_size(
        max(common.pad_total(int(max_len), word=False), 1), 64)


def _quirk_out_of_range(L: int, mat: np.ndarray, gapO: int,
                        gapE: int) -> bool:
    """The quirk value-range guard: the segmented-scan bias that reproduces
    the lane-block E quirk needs value headroom, so with the quirk on,
    reads of lane bucket L past it run on the exact oracle instead."""
    max_sub = int(np.max(np.abs(mat)))
    return needs_quirk(mat, gapE) and (
        L * (max_sub + gapE) + gapO >= int(scan_sw.SEG_BUMP))


class _Pending:
    """An in-flight align_batch: device work launched, host work deferred.

    Three stages let a driver overlap host work with device compute across
    batches (the reference CLI is strictly serial, ref: src/main.c:462):
      launch — uploads + forward + speculative suboptimal scan queued;
      mid    — forward results downloaded, rare tier re-runs resolved,
               begin-finding reverse passes queued;
      finish — reverse results downloaded, warnings, traceback, results.
    """
    __slots__ = ("B", "parts", "results", "stage")

    def __init__(self, results=None):
        self.results = results
        self.parts = []
        self.stage = 0


def _subset_req(req: BatchRequest, idx, mask_all) -> BatchRequest:
    return BatchRequest(
        reads=[req.reads[i] for i in idx], ref=req.ref, mat=req.mat,
        gapO=req.gapO, gapE=req.gapE, flag=req.flag,
        filters=req.filters, filterd=req.filterd,
        mask_len=[int(mask_all[i]) for i in idx],
        score_size=req.score_size)


def _plan_leaves(req: BatchRequest) -> list:
    """The one split of a request into leaves, for every leaf path:
    [(global indices, leaf request, streaming)] in the order they run;
    streaming is None for a leaf of the exact oracle (pipeline_fallback).
    gapO <= gapE makes the whole request one oracle leaf (module
    docstring).  Else the reads group by lane bucket (_length_groups; a
    single group keeps the request's order); a group past the quirk
    value-range guard is one oracle leaf, and any other splits into leaves
    of _rows_per_leaf reads at the group's L and streaming rule: the JAX
    package's split, which decides the order of stderr warnings."""
    B = len(req.reads)
    if B == 0:
        return []
    if req.gapO <= req.gapE:
        return [(list(range(B)), req, None)]
    mask_all = _as_masklen_array(req.mask_len, B)
    Ls = [_lane_bucket(len(r)) for r in req.reads]
    groups = _length_groups(Ls)
    Rp_est = common.bucket_size(len(req.ref), 256)
    out = []
    for idx in (groups if len(groups) > 1 else [list(range(B))]):
        L = max(Ls[i] for i in idx)
        if _quirk_out_of_range(L, req.mat, req.gapO, req.gapE):
            out.append((idx, _subset_req(req, idx, mask_all), None))
            continue
        streaming = _use_streaming(Rp_est, L)
        b_mem = _rows_per_leaf(Rp_est, L, streaming)
        for lo in range(0, len(idx), b_mem):
            part = idx[lo:lo + b_mem]
            out.append((part, _subset_req(req, part, mask_all), streaming))
    return out


def align_batch(req: BatchRequest, device=None) -> list[oracle.AlignResult]:
    """Align every read in the batch against req.ref.

    Returns AlignResult per read with the same field semantics as the
    reference's s_align (ref: src/ssw.h:55-66); entries are None where the
    reference returns NULL (score_size=0 overflow).
    """
    with profiling.span("pipeline.align_batch"):
        return _run_leaves(req, _plan_leaves(req), resolve_device(device))


def _run_leaves(req: BatchRequest, leaves, dev) -> list:
    """The synchronous path: the plan's leaves one after another, each
    through prepare, queue, mid and finish on the caller's stream, or
    through the oracle."""
    results: list = [None] * len(req.reads)
    for idx, leaf_req, streaming in leaves:
        if streaming is None:
            out = pipeline_fallback(leaf_req)
        else:
            with profiling.span("pipeline.launch"):
                st = _leaf_queue(_leaf_prepare(leaf_req, dev, streaming))
            with profiling.span("pipeline.mid"):
                _leaf_mid(st)
            with profiling.span("pipeline.finish"):
                out = _leaf_finish(st)
        for i, r in zip(idx, out):
            results[i] = r
    return results


def _sm_count(dev) -> int:
    """Streaming multiprocessors of `dev` (0 on the CPU: no schedule)."""
    return cuda_sw._sm_count(dev)


def _forward_blocks(st) -> int:
    """Blocks of the leaf's forward launch, as the launch will have them:
    the packed launch's from cuda_sw.packed_launch on the arguments
    _packed_forward gives it (its stretches fill the card), else a block of
    four warps per four reads."""
    if st.plan is None:
        return -(-st.B // 4)
    slot_max = int(st.plan.slot_len.max())
    return cuda_sw.packed_launch(
        st.B, slot_max, st.n + 1, st.ref_len, st.max_sub, st.req.gapO,
        st.req.gapE, st.quirk, st.dual, st.dev,
        gate=_gate(st.plan.L, st.req.gapO, st.req.gapE, st.max_sub,
                   slot_max))[3]


def _forward_waves(leaves, sms: int) -> list:
    """The waves in which a call launches its leaves' forward passes: each
    wave starts on the device when the previous one's forwards have ended.

    leaves: (blocks, L) per leaf, in the plan's order (_forward_blocks).
    Unsplit, a forward block scans the whole target, so a leaf keeps about
    `blocks` SMs busy for a time that grows with its lane bucket L.  Blocks
    of two launches that share an SM each run slower, and a block never
    moves to an SM that frees: on the H100 the Ion Torrent headline's five
    leaves, started at once in the plan's order (shortest first), crowded
    the longest ones' blocks on a few SMs and took as long as one after
    another (PERF.md §6).  So the leaves are packed into waves of at most
    `sms` blocks, first fit in descending L (longest first); a leaf of more
    blocks than SMs, as every packed leaf whose stretches fill the card
    (cuda_sw.packed_launch), is a wave of its own.  sms 0 (the CPU): one
    wave, in the plan's order.  Returns lists of leaf indices."""
    if not sms:
        return [list(range(len(leaves)))]
    waves = []  # [blocks, leaf indices]
    for i in sorted(range(len(leaves)), key=lambda i: -leaves[i][1]):
        need = leaves[i][0]
        for w in waves:
            if w[0] + need <= sms:
                w[0] += need
                w[1].append(i)
                break
        else:
            waves.append([need, [i]])
    return [w[1] for w in waves]


def align_batch_launch(req: BatchRequest, device=None) -> _Pending:
    """Start align_batch asynchronously: queue all device work (uploads,
    forward passes, speculative suboptimal scans) and return without a
    device sync.  Drive with align_batch_mid (downloads + reverse-pass
    launches) and align_batch_finish (results).

    Requests whose host/device interleaving cannot be deferred (an oracle
    leaf in the plan, score_size != 2) run synchronously here so warning
    order on stderr is identical to the serial path."""
    dev = resolve_device(device)
    with profiling.span("pipeline.launch"):
        leaves = _plan_leaves(req)
        queued = req.score_size == 2 and all(
            streaming is not None for _, _, streaming in leaves)
        if queued:
            pend = _Pending()
            pend.B = len(req.reads)
            states = [_leaf_prepare(leaf_req, dev, streaming)
                      for _, leaf_req, streaming in leaves]
            prev: list = []
            for wave in _forward_waves(
                    [(_forward_blocks(st), st.L) for st in states],
                    _sm_count(dev)):
                for i in wave:
                    _leaf_queue(states[i], pooled=True,
                                after=[states[j].fwd_done for j in prev])
                prev = wave
            # mid and finish take the leaves in the plan's order
            pend.parts = [(leaf[0], st) for leaf, st in zip(leaves, states)]
    if not queued:
        with profiling.span("pipeline.align_batch"):
            return _Pending(results=_run_leaves(req, leaves, dev))
    return pend


def align_batch_mid(pend: _Pending) -> _Pending:
    if pend.results is None and pend.stage < 1:
        with profiling.span("pipeline.mid"):
            for _, st in pend.parts:
                with torch.cuda.stream(st.stream):
                    _leaf_mid(st)
        pend.stage = 1
    return pend


def align_batch_scores(pend: _Pending) -> np.ndarray:
    """score1 per read once the forward stage is resolved (drives mid if
    needed).  Strand-selection drivers (-r) use this to build the `detail`
    mask for align_batch_finish before paying for any traceback."""
    align_batch_mid(pend)
    if pend.results is not None:
        return np.array([0 if r is None else r.score1
                         for r in pend.results], dtype=np.int64)
    out = np.zeros(pend.B, dtype=np.int64)
    for idx, st in pend.parts:
        out[list(idx)] = st.score
    return out


def align_batch_finish(pend: _Pending, detail=None) -> list:
    """Complete an align_batch_launch.  `detail` (optional bool mask, one
    per read) suppresses the banded traceback for False reads: the
    reference runs ssw_align for BOTH strands under -r but only the
    winner's cigar is ever observable (src/main.c:505-518), while the
    reverse pass must still run for every read because its stderr warning
    fires for losers too (src/ssw.c:932-935)."""
    if pend.results is not None:
        return pend.results
    align_batch_mid(pend)
    results: list = [None] * pend.B
    with profiling.span("pipeline.finish"):
        for idx, st in pend.parts:
            d = None if detail is None else np.asarray(detail)[list(idx)]
            for i, r in zip(idx, _leaf_finish(st, d)):
                results[i] = r
    pend.results = results
    return results


class _LeafState:
    """Mutable bag for one leaf batch's launch -> mid -> finish flow."""
    __slots__ = (
        "req", "dev", "streaming", "B", "n", "bias", "ref_len", "mask_len",
        "read_len", "L", "mat_ext_d", "reads_d", "rl_d", "quirk", "max_sub",
        "word_tier", "might", "dual", "gate", "ref_codes", "ref_ext", "D",
        "Wb", "Wb2", "plan", "keep", "col_word",
        "fwd_d", "sub_d", "bm_d",
        "score", "end_ref", "end_read", "score2", "ref_end2", "word",
        "null_mask", "fin", "stream", "fwd_done")

    def __init__(self):
        self.fin = self.stream = self.fwd_done = None


def _forward(st: _LeafState, reads_d, rl_d, col_word, seg_word: bool):
    """Profile + geometry + the forward kernel for rows reads_d: per-column
    maxima, or per-block maxima over the target's columns when streaming."""
    profile, cm_d, seg_d, ss_d = _prep_device(
        reads_d, rl_d, st.mat_ext_d, _to(st.dev, col_word), st.L, seg_word)
    return cuda_sw.forward_shared(profile, st.ref_codes, rl_d, cm_d, seg_d,
                                  ss_d, st.req.gapO, st.req.gapE, st.quirk,
                                  max_sub=st.max_sub, blockmax=st.streaming,
                                  valid_len=st.ref_len, gate=st.gate)


def _leaf_facts(req: BatchRequest, dev, streaming: bool) -> _LeafState:
    """The host-side facts of a leaf's reads that every path reads: read
    lengths, the lane bucket, the tiers, the gate."""
    st = _LeafState()
    st.req, st.dev, st.streaming = req, dev, streaming
    B = st.B = len(req.reads)
    st.n = req.mat.shape[0]
    st.bias = matrix_bias(req.mat)
    st.ref_len = len(req.ref)
    st.mask_len = _as_masklen_array(req.mask_len, B)
    read_len = st.read_len = np.array([len(r) for r in req.reads],
                                      dtype=np.int32)
    st.L = _lane_bucket(read_len.max())
    st.word_tier = req.score_size == 1
    st.quirk = needs_quirk(req.mat, req.gapE)
    st.max_sub = int(np.max(np.abs(req.mat)))
    # speculative tier masks: when the quirk is off, the tiers differ ONLY
    # in col_mask (rows padded to 16 vs 8 per lane block; byte pad rows
    # carry stale diagonal values into maxColumn).  A read whose maximum
    # possible score (read_len*max|mat| + bias) cannot reach 255 never
    # overflows, so give every *potentially* overflowing read the word-tier
    # row mask up front — if it does overflow, the reference's whole word
    # rerun (ref: src/ssw.c:883-886) is already answered; only
    # might-but-didn't reads re-run, with byte rows (_final_tiers).
    st.might = _might_overflow(read_len, req.score_size, st.quirk,
                               st.max_sub, st.bias)
    st.dual = _dual_tier(st.might, streaming)
    st.gate = _gate(st.L, req.gapO, req.gapE, st.max_sub)
    st.col_word = (np.zeros(B, bool) if st.dual
                   else np.full(B, st.word_tier) | st.might)
    return st


def _leaf_prepare(req: BatchRequest, dev, streaming: bool) -> _LeafState:
    """A planned leaf's _leaf_facts, its target on the device (_device_ref)
    and its lane packing: the _LeafState for _leaf_queue."""
    st = _leaf_facts(req, dev, streaming)
    B, n, L = st.B, st.n, st.L
    # pad the target to a coarse bucket with the virtual letter: padded
    # columns carry values diagonally at zero cost but can never strictly
    # exceed the running max, and are masked out of the suboptimal scan
    Rp = common.bucket_size(st.ref_len, 256)
    if streaming:
        # window sizes of the streaming suboptimal scan's per-read re-runs;
        # the device target gets Wb extra pad so window slices never clamp
        st.D = _restart_margin(L, req.mat, req.gapO, req.gapE)
        ml_max = int(st.mask_len.max())
        st.Wb = common.round_up(st.D + 2 * ml_max + 2 * subopt.BM + 64, 256)
        st.Wb2 = common.round_up(st.D + subopt.BM + 64, 256)
        st.ref_ext = _device_ref(req.ref, n, Rp + st.Wb, dev)
        st.ref_codes = st.ref_ext[:Rp]
    else:
        st.ref_ext = None
        st.ref_codes = _device_ref(req.ref, n, Rp, dev)
    st.plan = st.keep = None
    if streaming and PACK is not False:
        # plan as the JAX package's Pallas path does, on the batch padded
        # to a multiple of 64 reads with copies of read 0, so that PACK =
        # True packs what it packs; the copies' slots are never launched
        st.keep = np.concatenate(
            [np.arange(B), np.zeros(common.round_up(B, 64) - B, np.int64)])
        plan = (_pack_rule if PACK is None else _plan_pack)(
            st.read_len[st.keep], st.col_word[st.keep], len(st.keep), L)
        if plan is not None and st.quirk and not pack.quirk_span_ok(
                int(plan.slot_len.max()), st.max_sub, req.gapO, req.gapE):
            plan = None  # the quirk's sub-slot block bias would not be exact
        st.plan = plan
    return st


def _leaf_queue(st: _LeafState, pooled: bool = False, after=()):
    """Queue the prepared leaf's device work: upload, forward pass, and
    (when not streaming) the speculative suboptimal scan.  No host<->device
    syncs.  pooled (the asynchronous path, where several leaves are in
    flight): every device operation of the leaf, from here to its last
    download in _leaf_finish, runs on a stream of its own (_leaf_stream,
    st.stream), so that each download waits for its own leaf alone; its
    forward launch waits on the device for the events `after` (the
    previous wave's fwd_done, _forward_waves) and records st.fwd_done.

    The suboptimal scan launches before the byte-overflow tier decision is
    known by using the speculative col_word tiers for its window-edge
    asymmetry: every read whose speculative tier differs from its final
    tier is exactly the set the word re-run re-scans (need_word implies
    might), so the re-run's own suboptimal results overwrite any
    speculative mismatch — final outputs are identical to deciding first.

    Returns st."""
    req, dev, streaming = st.req, st.dev, st.streaming
    B, n, L, ref_len = st.B, st.n, st.L, st.ref_len
    read_len, quirk, max_sub = st.read_len, st.quirk, st.max_sub
    word_tier, dual, col_word, plan = (st.word_tier, st.dual, st.col_word,
                                       st.plan)
    profiling.add_pairs(read_len, ref_len)
    reads_padded = common.pad_reads(req.reads, L, pad_code=n)
    # the target went up on the caller's stream (_device_ref: shared by
    # leaves and calls); the rest of the leaf's device work goes on the
    # leaf's own stream when pooled
    if pooled:
        st.stream = _leaf_stream(dev,
                                 st.ref_ext if streaming else st.ref_codes)
    with torch.cuda.stream(st.stream):
        st.mat_ext_d = _to(dev, common.extend_matrix(req.mat), torch.int8)
        # one upload of the read codes serves forward, rerun and reverse
        # passes
        st.reads_d = _to(dev, reads_padded, torch.int8)
        st.rl_d = _to(dev, read_len)
        for ev in after:
            st.stream.wait_event(ev)
        if plan is not None:
            pprof, tables = _packed_inputs(plan, reads_padded[st.keep],
                                           read_len[st.keep], B, n,
                                           st.mat_ext_d)
            score_d, er_d, ed_d, mc_d = _packed_forward(
                plan, pprof, st.ref_codes, tables, req.gapO, req.gapE,
                max_sub, ref_len, quirk, bool(word_tier), dual)
        elif dual:
            profile, cm_d, seg_d, ss_d = _prep_device(
                st.reads_d, st.rl_d, st.mat_ext_d, _to(dev, col_word), L,
                word_tier)
            score_d, er_d, ed_d, mc_d = cuda_sw.forward_shared(
                profile, st.ref_codes, st.rl_d, cm_d, seg_d, ss_d, req.gapO,
                req.gapE, quirk, max_sub=max_sub, blockmax=True,
                valid_len=ref_len, wmask=_word_mask(st.rl_d, L),
                gate=st.gate)
        else:
            score_d, er_d, ed_d, mc_d = _forward(st, st.reads_d, st.rl_d,
                                                 col_word, word_tier)
        st.fwd_d = torch.stack([score_d, er_d, ed_d])
        if st.stream is not None:
            st.fwd_done = torch.cuda.Event()
            st.fwd_done.record(st.stream)
        if streaming:
            st.bm_d, st.sub_d = mc_d, None  # (B, nblk) block maxima, for mid
            return st
        # speculative suboptimal launch (col_word edges, see docstring);
        # the big (B, Rp) maxima buffer is consumed right here in the
        # device queue and freed — only (B,) results stay in flight
        s2_d, re2_d = scan_sw.second_best_batch(
            mc_d, er_d, _to(dev, st.mask_len), ref_len, _to(dev, col_word))
        del mc_d
        st.bm_d, st.sub_d = None, torch.stack([s2_d, re2_d])
        return st


def _leaf_mid(st: _LeafState):
    """Download forward + speculative suboptimal results, resolve tier
    re-runs, and queue the begin-finding reverse passes, on the current
    stream (the caller makes st.stream current)."""
    ref_len = st.ref_len
    with _phase("forward"):
        # ONE stacked download (the only sync of the forward stage)
        profiling.count("syncs")
        if st.sub_d is not None:
            packed = torch.cat([st.fwd_d, st.sub_d]).cpu().numpy()
            score2, ref_end2 = packed[3].copy(), packed[4].copy()
        else:
            packed = st.fwd_d.cpu().numpy()
            score2 = ref_end2 = None
        st.fwd_d = st.sub_d = None
    score, end_ref, end_read = (packed[0].copy(), packed[1].copy(),
                                packed[2].copy())

    def rerun(idx, rerun_word: bool):
        idx_d = _to(st.dev, idx)
        k = len(idx)
        with _phase("rerun"):
            profiling.add_pairs(st.read_len[idx], ref_len)
            s_r, er_r, ed_r, mc_r = _forward(
                st, st.reads_d[idx_d], st.rl_d[idx_d],
                np.full(k, rerun_word), rerun_word)
            profiling.count("syncs")
            packed_r = torch.stack([s_r, er_r, ed_r]).cpu().numpy()
            score[idx] = packed_r[0]
            end_ref[idx] = packed_r[1]
            end_read[idx] = packed_r[2]
        with _phase("suboptimal"):
            if st.streaming:
                # splice the rerun tier's block maxima in: `word` is
                # already each read's final tier, so one composition below
                # serves the whole leaf (in place: the leaf owns bm_d)
                st.bm_d[idx_d] = mc_r
            else:
                # the rerun tier's suboptimal scan runs directly on the
                # rerun's per-column maxima (no splice into a (B, R) array)
                s2_r, re2_r = scan_sw.second_best_batch(
                    mc_r, er_r, _to(st.dev, st.mask_len[idx]), ref_len,
                    torch.full((k,), rerun_word, dtype=torch.bool,
                               device=st.dev))
                profiling.count("syncs")
                packed2r = torch.stack([s2_r, re2_r]).cpu().numpy()
                score2[idx] = packed2r[0]
                ref_end2[idx] = packed2r[1]

    word, score = _final_tiers(st, score, st.might, rerun)
    if st.streaming:
        with _phase("suboptimal"):
            if st.dual:
                # (B, 2, nblk): each read's final tier's channel
                bm = st.bm_d
                st.bm_d = torch.where(_to(st.dev, word)[:, None], bm[:, 1],
                                      bm[:, 0])
            score2, ref_end2 = _second_best_streaming(st, end_ref, word)
    _finish_launch(st, score, end_ref, end_read, score2, ref_end2, word)
    return st


def _leaf_finish(st: _LeafState, detail=None) -> list:
    """Download the reverse passes and finish the results on the leaf's
    stream, then hand the stream back to its pool: the leaf's last
    download is done."""
    with torch.cuda.stream(st.stream):
        results = _finish_complete(st, detail)
    if st.stream is not None:
        _POOLS[str(st.dev)].give(st.stream)
        st.stream = None
    return results


def _finish_launch(st: _LeafState, score, end_ref, end_read, score2,
                   ref_end2, word):
    """Take the leaf's final forward results (from any path), honour
    score_size 0 (NULL on byte overflow, ref: src/ssw.c:887-891), gate by
    filter and flag, and queue the per-tier begin-finding reverse passes
    (device; no downloads) into st.fin."""
    st.score, st.end_ref, st.end_read = score, end_ref, end_read
    st.score2, st.ref_end2, st.word = score2, ref_end2, word
    req, B = st.req, st.B
    st.null_mask = np.zeros(B, dtype=bool)
    if req.score_size == 0:
        st.null_mask = score + st.bias >= 255
        for _ in range(int(st.null_mask.sum())):  # ref: src/ssw.c:888
            sys.stderr.write(
                "Please set 2 to the score_size parameter of the function "
                "ssw_init, otherwise the alignment results will be "
                "incorrect.\n")

    # which reads need the reverse pass / cigar
    aligned = score > 0
    want_begin = np.zeros(B, dtype=bool)
    want_cigar = np.zeros(B, dtype=bool)
    f = req.flag
    for b in range(B):
        if not aligned[b] or st.null_mask[b]:
            continue
        if f == 0 or (f == 2 and score[b] < req.filters):
            continue
        want_begin[b] = True
        if (f & 7) == 0 or ((f & 2) and score[b] < req.filters):
            continue
        want_cigar[b] = True  # distance filter needs begins; re-checked below

    rev = []
    for tier in (False, True):  # reverse tier must match the forward tier
        sel = want_begin & (st.word == tier)
        if not sel.any():
            continue
        idx = np.nonzero(sel)[0]
        W = _window_len(int((st.end_read[idx] + 1).max()), st.ref_len,
                        req.mat, req.gapO, req.gapE)
        with _phase("reverse"), profiling.span("pipeline.reverse_launch"):
            handle = _reverse_launch(st, idx, W, tier)
        rev.append((idx, handle))
    st.fin = aligned, want_begin, want_cigar, rev


def _finish_complete(st: _LeafState, detail=None):
    req, score, end_ref, end_read = st.req, st.score, st.end_ref, st.end_read
    aligned, want_begin, want_cigar, rev = st.fin
    if detail is not None:
        # skip ONLY the traceback for masked reads — begins and the
        # reverse-pass warning stay (see align_batch_finish docstring)
        want_cigar = want_cigar & np.asarray(detail, dtype=bool)
    B, mask_len, null_mask = st.B, st.mask_len, st.null_mask
    results: list[oracle.AlignResult | None] = []
    f = req.flag

    ref_begin = np.full(B, -1, dtype=np.int32)
    read_begin = np.full(B, -1, dtype=np.int32)
    miss_part = np.zeros(B, dtype=bool)
    for idx, handle in rev:
        with _phase("reverse"), profiling.span("pipeline.reverse_wait"):
            rb, qb, rev_score = _reverse_complete(handle, idx, end_ref,
                                                  end_read)
        ref_begin[idx] = rb
        read_begin[idx] = qb
        # ref: src/ssw.c:932-935 — the banded traceback will miss a part
        miss_part[idx] = score[idx] > rev_score
    for _ in range(int(miss_part.sum())):
        sys.stderr.write("Warning: The alignment path of one pair of "
                         "sequences may miss a small part. "
                         "[ssw.c ssw_align]\n")

    cigar_jobs: list[tuple[int, oracle.AlignResult]] = []
    for b in range(B):
        if null_mask[b]:
            results.append(None)
            continue
        r = oracle.AlignResult()
        if not aligned[b]:
            results.append(r)
            continue
        r.score1 = int(score[b])
        r.ref_end1 = int(end_ref[b])
        r.read_end1 = int(end_read[b])
        if mask_len[b] >= 15:
            r.score2 = int(st.score2[b])
            r.ref_end2 = int(st.ref_end2[b])
        else:
            r.score2, r.ref_end2 = 0, -1
        if want_begin[b]:
            r.ref_begin1 = int(ref_begin[b])
            r.read_begin1 = int(read_begin[b])
            if miss_part[b]:
                r.flag = 2
        do_cigar = want_cigar[b]
        if do_cigar and (f & 4):
            if (r.ref_end1 - r.ref_begin1 > req.filterd or
                    r.read_end1 - r.read_begin1 > req.filterd):
                do_cigar = False
        if do_cigar:
            cigar_jobs.append((b, r))
        results.append(r)
    if cigar_jobs:
        # one threaded native call for the whole batch's tracebacks
        # (ref: src/ssw.c:940-957 runs per pair; pairs are independent)
        from ssw_tpu_torch.ops import banded

        with _phase("traceback"):
            paths = banded.banded_cigar_batch(
                [req.ref[r.ref_begin1:r.ref_end1 + 1]
                 for _, r in cigar_jobs],
                [req.reads[b][r.read_begin1:r.read_end1 + 1]
                 for b, r in cigar_jobs],
                [r.score1 for _, r in cigar_jobs],
                req.gapO, req.gapE, req.mat)
        for (_, r), path in zip(cigar_jobs, paths):
            if path is None:
                r.flag = 1
            else:
                r.cigar = path
    return results


def pipeline_fallback(req: BatchRequest) -> list:
    """Per-pair oracle path (bug-compatible lazy-F semantics when
    gapO <= gapE; see align_batch)."""
    mask_len = _as_masklen_array(req.mask_len, len(req.reads))
    return [
        oracle.ssw_align(r, req.ref, req.mat, req.gapO, req.gapE,
                         flag=req.flag, filters=req.filters,
                         filterd=req.filterd, mask_len=int(mask_len[b]),
                         score_size=req.score_size)
        for b, r in enumerate(req.reads)
    ]


def _second_best_streaming(st: _LeafState, end_ref, word):
    """Bounded-memory (score2, ref_end2), bit-identical to
    scan_sw.second_best_batch on the full per-column maxima (ref:
    src/ssw.c:358-381): block maxima from the forward kernel's blockmax
    mode (st.bm_d, consumed here), column resolution near the exclusion
    window and inside the winning block from two per-read window re-runs
    of the DP (forward_perread with emit_maxcol, from zero state D columns
    early: exact by the restart margin, ops/subopt.py).  Device work, one
    download."""
    dev, req, BM = st.dev, st.req, subopt.BM
    er = _to(dev, end_ref.astype(np.int32))
    ml = _to(dev, st.mask_len)
    word_d = _to(dev, np.asarray(word, dtype=bool))
    lo = (er - ml).clamp_min(0)
    ws = ((lo // BM) * BM - st.D).clamp_min(0)

    # per-read FINAL-tier geometry: mixed byte/word rows (and mixed seg
    # geometries on the quirk path) in one batch
    prof, cm, seg, ss = _prep_core(st.reads_d, st.rl_d, st.mat_ext_d,
                                   word_d, word_d, st.L)

    def window_maxima(starts, W):
        refw = subopt.gather_windows(st.ref_ext, starts, W)
        return cuda_sw.forward_perread(prof, refw, st.rl_d, cm, seg, ss,
                                       req.gapO, req.gapE, st.quirk,
                                       emit_maxcol=True)[3]

    s2, hasA, hasP, hasB, firstP_i, bstar = subopt.compose_window(
        st.bm_d, window_maxima(ws, st.Wb), ws, er, ml, word_d, st.ref_len)
    st.bm_d = None

    # resolve the first-attaining column of block-region winners with a
    # second bounded re-run (run for every read: one launch, small)
    ws2 = (bstar * BM - st.D).clamp_min(0)
    fc = subopt.resolve_block(window_maxima(ws2, st.Wb2), ws2, bstar, s2,
                              st.ref_len)

    # ordered-region precedence: blocks before the window, then the partial
    # zone, then blocks after (the full scan's first-index tie-break)
    ref_end2 = torch.where(hasA, fc,
                           torch.where(hasP, firstP_i,
                                       torch.where(hasB, fc, 0)))
    ref_end2 = torch.where(s2 > 0, ref_end2, 0)
    profiling.count("syncs")
    packed = torch.stack([s2, ref_end2]).cpu().numpy()
    return packed[0].copy(), packed[1].copy()


def _reverse_core(reads_d, er, ed, score1, ref_dev, mat_ext_d, *, L, W, n,
                  gapO, gapE, quirk, tier_word):
    """The begin-finding reverse pass with the reversed read prefixes and
    per-read reversed reference windows built ON DEVICE
    (rev_reads[k, j] = read[k][ed[k] - j], refw[k, w] = ref[er[k] - w];
    out-of-range -> the virtual letter n)."""
    dev = reads_d.device
    rl_rev = ed + 1
    j = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    src = ed[:, None] - j
    rev_reads = torch.where(
        src >= 0,
        torch.gather(reads_d, 1,
                     src.clamp(0, reads_d.shape[1] - 1).long()), n)
    w = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    ridx = er[:, None] - w
    refw = torch.where(ridx >= 0, ref_dev[ridx.clamp_min(0).long()],
                       n).to(torch.int32).contiguous()
    tiers = torch.full(rl_rev.shape, tier_word, dtype=torch.bool,
                       device=dev)
    profile, cm_d, seg_d, ss_d = _prep_core(rev_reads, rl_rev, mat_ext_d,
                                            tiers, tiers, L)
    s, rer, red = cuda_sw.forward_perread(profile, refw, rl_rev, cm_d,
                                          seg_d, ss_d, gapO, gapE, quirk,
                                          terminate=score1)[:3]
    return torch.stack([s, rer, red])


def _reverse_launch(st: _LeafState, idx: np.ndarray, W: int,
                    tier_word: bool):
    """Queue the batched begin-finding pass over reversed prefixes (static
    window W) with the reference's terminate-at-score1 column-loop break
    (ref: src/ssw.c:918-930).  Returns a device handle; complete with
    _reverse_complete.  The reads and the target come from the leaf's
    device-resident copies (the forward L bounds the reverse L: word-tier
    padding never exceeds byte-tier padding)."""
    req, dev = st.req, st.dev
    rl_rev = (st.end_read[idx] + 1).astype(np.int32)
    L = common.bucket_size(
        int(common.pad_total(int(rl_rev.max()), word=tier_word)), 64)
    idx_d = _to(dev, idx)
    stacked = _reverse_core(
        st.reads_d[idx_d, :L].contiguous(),
        _to(dev, st.end_ref[idx].astype(np.int32)),
        _to(dev, st.end_read[idx].astype(np.int32)),
        _to(dev, st.score[idx].astype(np.int32)),
        st.ref_codes, st.mat_ext_d,
        L=L, W=W, n=st.n, gapO=req.gapO, gapE=req.gapE, quirk=st.quirk,
        tier_word=tier_word)
    return stacked


def _reverse_complete(handle, idx, end_ref, end_read):
    """Download a _reverse_launch result and derive begins."""
    profiling.count("syncs")
    packed = handle.cpu().numpy()
    s, er, ed = packed[0], packed[1], packed[2]
    ref_begin = end_ref[idx] - er
    read_begin = end_read[idx] - ed
    return (ref_begin.astype(np.int32), read_begin.astype(np.int32), s)


def align_batch_sharded(req: BatchRequest, mesh, device=None) -> list:
    """align_batch with the forward pass + suboptimal scan running over a
    (data x seq) device mesh (parallel/mesh.py): reads data-parallel, the
    target sequence-parallel with halo re-compute and the best-hit merge
    (parallel/dist.py).  The begin-finding reverse pass and the traceback
    run on `device` (default mesh.devices[0, 0]).  Bit-identical to
    align_batch; the counterpart of the JAX package's
    pipeline.align_batch_sharded."""
    B = len(req.reads)
    if B == 0:
        return []
    if req.gapO <= req.gapE:
        return pipeline_fallback(req)
    dev = resolve_device(mesh.devices[0, 0] if device is None else device)
    st = _leaf_facts(req, dev, False)
    n, ref_len, L = st.n, st.ref_len, st.L
    if _quirk_out_of_range(L, req.mat, req.gapO, req.gapE):
        return pipeline_fallback(req)

    # pad the reads to a multiple of the data axis with copies of read 0
    D = mesh.shape["data"]
    S = mesh.shape["seq"]
    Bp = (B + D - 1) // D * D
    pad = np.concatenate([np.arange(B), np.zeros(Bp - B, np.int64)])
    read_len = st.read_len[pad]
    ml = np.concatenate([np.maximum(st.mask_len, 0),
                         np.full(Bp - B, 15, np.int32)])
    reads_padded = common.pad_reads([req.reads[i] for i in pad], L,
                                    pad_code=n)

    # pad the target so every seq shard gets the same column count; the
    # virtual letter rides diagonally at zero cost and padded columns are
    # masked out of the suboptimal scan by ref_len.  Shard 0's halo is the
    # virtual letter too.
    halo = _window_len(int(read_len.max()), ref_len, req.mat, req.gapO,
                       req.gapE)
    Rp = (ref_len + 256 * S - 1) // (256 * S) * (256 * S)
    ref_ext = np.full(halo + Rp, n, dtype=np.int32)
    ref_ext[halo:halo + ref_len] = req.ref
    # one upload each serves forward, re-run and reverse passes
    ref_ext_d = _to(dev, ref_ext)
    mat_ext_d = _to(dev, common.extend_matrix(req.mat), torch.int8)
    reads_d = _to(dev, reads_padded, torch.int8)
    rl_d = _to(dev, read_len)
    ml_d = _to(dev, ml)
    profiling.add_pairs(st.read_len, ref_len)

    def fwd(rows_d, col_word, seg_word: bool):
        """The sharded forward pass of reads rows_d (device indices, or
        None for all): one stacked download of its five (k,) results."""
        sel = (lambda x: x) if rows_d is None else (lambda x: x[rows_d])
        profile, cm_d, seg_d, ss_d = _prep_device(
            sel(reads_d), sel(rl_d), mat_ext_d, _to(dev, col_word), L,
            seg_word)
        out = dist.sharded_forward(
            mesh, profile, ref_ext_d, sel(rl_d), cm_d, seg_d, ss_d,
            req.gapO, req.gapE, sel(ml_d), ref_len, halo, st.quirk,
            _to(dev, col_word), max_sub=st.max_sub, gate=st.gate)
        profiling.count("syncs")
        return [x.copy() for x in torch.stack(out).cpu().numpy()]

    with _phase("forward"):
        fwd_out = fwd(None, st.col_word[pad], st.word_tier)

    def rerun(idx, rerun_word: bool):
        # padded to a stable size that stays divisible by the data axis
        k = len(idx)
        unit = 64 if 64 % D == 0 else 64 * D
        idx_p = np.concatenate(
            [idx, np.repeat(idx[:1], common.round_up(k, unit) - k)])
        with _phase("rerun"):
            profiling.add_pairs(read_len[idx], ref_len)
            out = fwd(_to(dev, idx_p), np.full(len(idx_p), rerun_word),
                      rerun_word)
        for a, r in zip(fwd_out, out):
            a[idx] = r[:k]

    word, score = _final_tiers(st, fwd_out[0], st.might[pad], rerun)
    _, end_ref, end_read, score2, ref_end2 = fwd_out
    st.reads_d, st.mat_ext_d = reads_d, mat_ext_d
    st.ref_codes = ref_ext_d[halo:]
    # drop the data-parallel padding before the host stages (no duplicate
    # warnings or tracebacks)
    _finish_launch(st, score[:B], end_ref[:B], end_read[:B], score2[:B],
                   ref_end2[:B], word[:B])
    return _leaf_finish(st)
