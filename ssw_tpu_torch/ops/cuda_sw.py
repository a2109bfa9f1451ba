"""Wrappers of the hand-written CUDA DP kernels (csrc/sw_forward.cu,
csrc/sw_forward_i16.cu, csrc/sw_perread.cu).

Each wrapper takes the tensors of its plain twin in ops/scan_sw.py.  A
tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises: there is no fallback.  The wrapper checks
device, dtype, shape and contiguity, allocates the outputs on the input's
device, launches on PyTorch's current stream without synchronising, raises
if the launch reports an error, and counts the launch in LAUNCHES.
"""

from __future__ import annotations

import numpy as np
import torch

from ssw_tpu_torch.ops import _kernels, common, scan_sw

# int32 operations per lane-cell and column that the recurrence needs, as
# sw_dp.cuh dp_column issues them (DPX fusions counted as one): h~ (add-max
# with 0), c folded into the lane total (add-max), H (add-max with 0), the
# running prefix (add-max), E (sub + add-max with 0), the masked column max
# (1).  The quirk adds the biased lane total (add-max), h_fp (add-max with
# 0 + select at block starts) and the biased running prefix (add-max).
# Shuffles, the warp scan and the reduce belong to the one-warp-per-read
# layout, not to the recurrence, and are not counted.  The int16 tier issues
# the same 7 as packed s16x2 instructions, each for two lane-cells.
OPS_PER_CELL = 7
OPS_PER_CELL_QUIRK = 11
OPS_PER_CELL_I16 = OPS_PER_CELL / 2

# the int16 tier is exact while every cell and intermediate stays below
# this bound (the JAX package's pallas_sw.I16_HEADROOM)
I16_HEADROOM = 2 ** 14

# kernel launches per wrapper, counted right after each successful launch
LAUNCHES = {"forward_shared": 0, "forward_shared_i16": 0,
            "forward_perread": 0}


def i16_exact(L: int, gapO: int, gapE: int, max_sub: int | None,
              quirk: bool) -> bool:
    """True when the int16 tier is provably exact: every DP cell is bounded
    by L*max|mat| and every intermediate (c = h + lane*gapE - gapO, the
    lane-0 prefix fill) stays inside int16.  The quirk's SEG_BUMP bias needs
    int32.  Same rule as the JAX package's pallas_sw.i16_exact."""
    if quirk or max_sub is None:
        return False
    return L * (max_sub + gapE) + gapO < I16_HEADROOM


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.sw_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _geometry_checks(profile, read_len, col_mask, seg_id, seg_start):
    B, n1, L = profile.shape
    dev = profile.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with tensors on {dev}")
    if L % 32 or L == 0:
        raise ValueError(f"L = {L}: the kernels take multiples of 32")
    _check("profile", profile, torch.int8, (B, n1, L), dev)
    _check("read_len", read_len, torch.int32, (B,), dev)
    _check("col_mask", col_mask, torch.bool, (B, L), dev)
    _check("seg_id", seg_id, torch.int8, (B, L), dev)
    _check("seg_start", seg_start, torch.bool, (B, L), dev)
    return B, n1, L, dev


def _scratch(lib, fn, rows, L, dev):
    n = getattr(lib, fn)(L)
    return torch.empty((rows, n), dtype=torch.int32, device=dev) if n else None


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch_shared(profile, ref, read_len, col_mask, seg_id, seg_start,
                   gapO, gapE, quirk, i16):
    """One launch of the int32 kernel, or of the int16 tier (quirk off);
    not counted."""
    B, n1, L, dev = _geometry_checks(profile, read_len, col_mask, seg_id,
                                     seg_start)
    R = int(ref.shape[0])
    _check("ref", ref, torch.int32, (R,), dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_ref = torch.empty(B, dtype=torch.int32, device=dev)
    end_read = torch.empty(B, dtype=torch.int32, device=dev)
    maxcol = torch.empty((B, R), dtype=torch.int16, device=dev)
    outs = (score.data_ptr(), end_ref.data_ptr(), end_read.data_ptr(),
            maxcol.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if i16:
            lib = _kernels.load("sw_forward_i16")
            scratch = _scratch(lib, "sw_forward_i16_scratch_per_pair",
                               (B + 1) // 2, L, dev)
            rc = lib.sw_forward_shared_i16(
                profile.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
                col_mask.data_ptr(), B, n1, L, R, int(gapO), int(gapE),
                *outs, _ptr(scratch), stream)
        else:
            lib = _kernels.load("sw_forward")
            scratch = _scratch(lib, "sw_forward_scratch_per_read", B, L,
                               dev)
            rc = lib.sw_forward_shared(
                profile.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
                col_mask.data_ptr(), seg_id.data_ptr(), seg_start.data_ptr(),
                B, n1, L, R, int(gapO), int(gapE), int(bool(quirk)), *outs,
                _ptr(scratch), stream)
    _raise_on(lib, rc, "forward_shared_i16" if i16 else "forward_shared")
    return score, end_ref, end_read, maxcol


_I16_CHECKED: set = set()  # card indices where the int16 tier passed


def _i16_parity(dev):
    """Before the int16 tier first runs on a card, run it and the int32
    kernel on a fixed seeded workload inside the i16_exact bound and
    require identical outputs; raise if they differ.  This is the
    counterpart of the JAX package's _i16_supported probe, which gates its
    int16 tier on the same device parity check.  Runs once per card; its
    launches are comparisons and are not counted."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key in _I16_CHECKED:
        return
    rng = np.random.default_rng(7)
    B, L, R = 64, 128, 512
    mat = np.full((5, 5), -2, np.int8)
    np.fill_diagonal(mat, 2)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    read_len = np.full(B, L, np.int32)
    prof = common.build_profile(reads, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=False)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    args = (t(prof), t(rng.integers(0, 4, R).astype(np.int32)), t(read_len),
            t(geo.col_mask), t(geo.seg_id), t(geo.seg_start), 3, 1, False)
    want = _launch_shared(*args, i16=False)
    got = _launch_shared(*args, i16=True)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("the int16 tier of forward_shared disagrees with "
                           "the int32 kernel on the parity workload")
    _I16_CHECKED.add(key)


def forward_shared(profile, ref, read_len, col_mask, seg_id, seg_start,
                   gapO: int, gapE: int, quirk: bool = True,
                   max_sub: int | None = None):
    """Batched forward DP against one shared target.  Returns (score,
    end_ref, end_read (B,) int32, maxcol (B, R) int16 in [0, 32767]).

    profile (B, n+1, L) int8, ref (R,) int32, read_len (B,) int32,
    col_mask/seg_start (B, L) bool, seg_id (B, L) int8.  max_sub =
    max|substitution score| runs the int16 tier when i16_exact allows it
    (counted as forward_shared_i16); the results are the same."""
    if profile.device.type == "cpu":
        return scan_sw.forward_shared_ref(profile, ref, read_len, col_mask,
                                          seg_id, seg_start, gapO, gapE,
                                          quirk)
    i16 = i16_exact(int(profile.shape[2]), gapO, gapE, max_sub, quirk)
    if i16:
        _i16_parity(profile.device)
    out = _launch_shared(profile, ref, read_len, col_mask, seg_id,
                         seg_start, gapO, gapE, quirk, i16)
    LAUNCHES["forward_shared_i16" if i16 else "forward_shared"] += 1
    return out


def forward_perread(profile, refw, read_len, col_mask, seg_id, seg_start,
                    gapO: int, gapE: int, quirk: bool = True,
                    terminate=None, emit_maxcol: bool = False):
    """Forward DP over per-read windows refw (B, W) int32, with the
    terminate-at-score1 break (terminate (B,) int32, -1 = never).  Returns
    (score, end_ref, end_read) (+ maxcol (B, W) int32 with emit_maxcol)."""
    if profile.device.type == "cpu":
        return scan_sw.forward_perread_ref(
            profile, refw, read_len, col_mask, seg_id, seg_start, gapO,
            gapE, quirk, terminate=terminate, emit_maxcol=emit_maxcol)
    B, n1, L, dev = _geometry_checks(profile, read_len, col_mask, seg_id,
                                     seg_start)
    W = int(refw.shape[1])
    _check("refw", refw, torch.int32, (B, W), dev)
    if terminate is not None:
        _check("terminate", terminate, torch.int32, (B,), dev)
    lib = _kernels.load("sw_perread")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_ref = torch.empty(B, dtype=torch.int32, device=dev)
    end_read = torch.empty(B, dtype=torch.int32, device=dev)
    maxcol = (torch.empty((B, W), dtype=torch.int32, device=dev)
              if emit_maxcol else None)
    scratch = _scratch(lib, "sw_perread_scratch_per_read", B, L, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_forward_perread(
            profile.data_ptr(), refw.data_ptr(), _ptr(terminate),
            read_len.data_ptr(), col_mask.data_ptr(), seg_id.data_ptr(),
            seg_start.data_ptr(), B, n1, L, W, int(gapO), int(gapE),
            int(bool(quirk)), score.data_ptr(), end_ref.data_ptr(),
            end_read.data_ptr(), _ptr(maxcol), _ptr(scratch), stream)
    _raise_on(lib, rc, "forward_perread")
    LAUNCHES["forward_perread"] += 1
    out = (score, end_ref, end_read)
    return out + (maxcol,) if emit_maxcol else out


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
