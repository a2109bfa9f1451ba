"""Wrappers of the hand-written CUDA DP kernels (csrc/sw_forward.cu,
csrc/sw_forward_i16.cu, csrc/sw_forward_packed.cu, csrc/sw_perread.cu,
csrc/sw_wave_i16.cu, csrc/sw_wave_packed.cu, csrc/sw_wave_i32.cu,
csrc/sw_wave_perread.cu).  The two forward kernels have a base mode
(per-column maxima), a blockmax mode (per-256-column maxima, the streaming
suboptimal scan's input), a dual mode (blockmax for both tiers' row masks
at once) and an owned-column mode (forward_shared_gated: base mode with
global column indices and a best-hit gate, the sequence-parallel shards'
pass); the packed kernel runs lane-packed reads (ops/pack.py) in blockmax
or dual mode.  Each mode of each kernel has its own launch count, and
LIBRARY counts the launches of each library.

Two designs of every kernel.  A launch without the gate goes to the
anti-diagonal wavefront (sw_wave_i32, sw_wave_i16, sw_wave_packed,
sw_wave_perread; csrc/sw_wave.cuh); a gated launch, whose gate drops steps
of the warp scan, to the column-scan body (sw_forward, sw_forward_i16,
sw_forward_packed).  scan_body=True sends an ungated launch to the
column-scan body too: chip_smoke.py and the card tests compare and time
the two designs with it.  An int32 or per-read launch with the quirk goes
to the column-scan body where quirk_wave_exact does not hold (rows past
16,512 at int8 scores; the pipeline makes none).

Each wrapper takes the tensors of its plain twin in ops/scan_sw.py.  A
tensor on the CPU goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises: there is no fallback.  The wrapper checks
device, dtype, shape and contiguity, allocates the outputs on the input's
device, launches on PyTorch's current stream without synchronising, raises
if the launch reports an error, and counts the launch in LAUNCHES.

The three forward kernels take the bounded-radius gate (ops/gate.py) as
gate=, per-depth thresholds: the launch runs the kernel's Gate variant,
is counted in GATED too, and adds its warp-column steps by scan depth to a
device histogram that gate_steps() reads (a sync; only tests and
chip_smoke.py read it).  On the CPU the plain versions run the same gated
scan and count the same steps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ssw_tpu_torch import profiling
from ssw_tpu_torch.ops import _kernels, common, gate as gate_mod, pack, \
    scan_sw

# int32 operations per lane-cell and column that the recurrence needs, as
# sw_dp.cuh dp_column issues them (DPX fusions counted as one): h~ (add-max
# with 0), c folded into the lane total (add-max), H (add-max with 0), the
# running prefix (add-max), E (sub + add-max with 0), the masked column max
# (1).  The quirk adds the biased lane total (add-max), h_fp (add-max with
# 0 + select at block starts) and the biased running prefix (add-max).
# Shuffles, the warp scan and the reduce belong to the one-warp-per-read
# layout, not to the recurrence, and are not counted.  The int16 tier issues
# the same 7 as packed s16x2 instructions, each for two lane-cells.  The
# wavefront (sw_wave.cuh) issues the same 7 per lane-cell in another order.
OPS_PER_CELL = 7
OPS_PER_CELL_QUIRK = 11
OPS_PER_CELL_I16 = OPS_PER_CELL / 2
# blockmax mode: the same per lane-cell, plus the block's running max of the
# column maxima, once per read and column (one packed op for the two reads
# of an int16 warp)
OPS_PER_COLUMN_BLOCKMAX = 1
OPS_PER_COLUMN_BLOCKMAX_I16 = 0.5
# dual mode: the word channel's running max, one op per word-tier lane-cell
# (a packed op for the int16 tier's two lane-cells); its warp reduce once
# per 256 columns is not counted
OPS_PER_WORD_CELL_DUAL = 1
OPS_PER_WORD_CELL_DUAL_I16 = 0.5



def packed_ops(slot_len, read_len, cols: int, quirk: bool = False,
               dual: bool = False) -> int:
    """The counted operations of one forward_shared_packed launch over cols
    columns: the recurrence over each read's slot lanes (slot_len (B,)),
    the block running max per read and column, and with dual the word
    channel's max per word-tier lane-cell (a slot's lanes up to its read's
    length rounded up to 8, read_len (B,))."""
    sl = np.asarray(slot_len, np.int64)
    ops = ((OPS_PER_CELL_QUIRK if quirk else OPS_PER_CELL) * int(sl.sum())
           + OPS_PER_COLUMN_BLOCKMAX * len(sl)) * cols
    if dual:
        wl = np.minimum(sl, (np.asarray(read_len, np.int64) + 7) // 8 * 8)
        ops += OPS_PER_WORD_CELL_DUAL * int(wl.sum()) * cols
    return ops


# the int16 tier is exact while every cell and intermediate stays below
# this bound (the JAX package's pallas_sw.I16_HEADROOM)
I16_HEADROOM = 2 ** 14

# kernel launches per wrapper, counted right after each successful launch
LAUNCHES = {"forward_shared": 0, "forward_shared_i16": 0,
            "forward_shared_blockmax": 0, "forward_shared_i16_blockmax": 0,
            "forward_shared_dual": 0, "forward_shared_i16_dual": 0,
            "forward_shared_packed": 0, "forward_shared_packed_dual": 0,
            "forward_shared_owned": 0, "forward_shared_i16_owned": 0,
            "forward_perread": 0}
# of those, the launches that ran with the gate (forward kernels only)
GATED = {name: 0 for name in LAUNCHES if name != "forward_perread"}
# the same launches by the library that ran them (which design, for the
# int16 tier and the packed kernel)
LIBRARY = {name: 0 for name in _kernels.KERNELS}
# of the packed launches, those split into stretches (each also launches
# sw_wave_packed_merge_kernel)
SPLIT = {"forward_shared_packed": 0, "forward_shared_packed_dual": 0}
# per device: warp-column steps by scan depth 0..5 of the gated launches
_STEPS: dict = {}


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


def _steps(dev) -> torch.Tensor:
    """The (6,) int64 gate-step histogram of device dev."""
    key = str(dev)
    if key not in _STEPS:
        _STEPS[key] = torch.zeros(gate_mod.DEPTHS + 1, dtype=torch.int64,
                                  device=dev)
        if _STEPS[key].is_cuda:
            # zeroed before a launch on another leaf's stream adds to it
            torch.cuda.current_stream(dev).synchronize()
    return _STEPS[key]


def _gate_args(gate, dev):
    """(host int[5] thresholds, histogram pointer) for a launch, or (None,
    None) without the gate.  The array must outlive the launch call."""
    if gate is None:
        return None, None
    thr = tuple(int(t) for t in gate)
    if len(thr) != gate_mod.DEPTHS or list(thr) != sorted(thr):
        raise ValueError(f"gate: {gate!r} is not {gate_mod.DEPTHS} "
                         f"non-decreasing thresholds")
    return (ctypes.c_int * gate_mod.DEPTHS)(*thr), _steps(dev).data_ptr()


_SHARED_ENTRY = {"sw_wave_i16": "sw_wave_shared_i16",
                 "sw_forward_i16": "sw_forward_shared_i16",
                 "sw_wave_i32": "sw_wave_shared_i32",
                 "sw_forward": "sw_forward_shared"}


def quirk_wave_exact(L: int, max_sub: int | None) -> bool:
    """True when the wavefront's quirk (the G chain restarted at each lane
    block, csrc/sw_wave_i32.cu) equals the column scan's prefix max biased
    by seg_id * SEG_BUMP: with contiguous lane blocks (batch_geometry's),
    a source in an earlier block enters the biased scan at most L *
    max_sub - gapO - SEG_BUMP, which never wins while L * max_sub <=
    SEG_BUMP.  max_sub None: the int8 bound 127, so L <= 16,512."""
    return L * (127 if max_sub is None else max(int(max_sub), 0)) \
        <= scan_sw.SEG_BUMP


def _launch_shared(profile, ref, read_len, col_mask, seg_id, seg_start,
                   gapO, gapE, quirk, i16, blockmax=False, valid_len=None,
                   wmask=None, gate=None, idx=None, own=None,
                   scan_body=False, max_sub=None):
    """One launch of the int32 kernel, or of the int16 tier (quirk off), in
    base, blockmax or dual (wmask) mode, or in the owned-column mode (idx,
    own; base mode), gated with gate=; not counted.  Returns the outputs
    and the library that ran them: the wavefront without the gate unless
    scan_body (or, int32 with the quirk, outside quirk_wave_exact), else
    the column-scan body."""
    B, n1, L, dev = _geometry_checks(profile, read_len, col_mask, seg_id,
                                     seg_start)
    R = int(ref.shape[0])
    _check("ref", ref, torch.int32, (R,), dev)
    owned = idx is not None
    if owned:
        if blockmax:
            raise ValueError("the owned-column mode is a base mode")
        _check("idx", idx, torch.int32, (R,), dev)
        _check("own", own, torch.bool, (R,), dev)
    if wmask is not None:
        if quirk or not blockmax:
            raise ValueError("the dual tier is a blockmax mode with the "
                             "quirk off")
        _check("wmask", wmask, torch.bool, (B, L), dev)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_ref = torch.empty(B, dtype=torch.int32, device=dev)
    end_read = torch.empty(B, dtype=torch.int32, device=dev)
    if blockmax:
        vl = R if valid_len is None else min(int(valid_len), R)
        nblk = (R + scan_sw.BM - 1) // scan_sw.BM
        maxcol = torch.empty((B, 2, nblk) if wmask is not None else (B, nblk),
                             dtype=torch.int32, device=dev)
        mode = (None, maxcol.data_ptr(), vl)
    else:
        maxcol = torch.empty((B, R), dtype=torch.int16, device=dev)
        mode = (maxcol.data_ptr(), None, 0)
    outs = (score.data_ptr(), end_ref.data_ptr(), end_read.data_ptr(),
            *mode)
    thr, hist = _gate_args(gate, dev)
    wave = gate is None and not scan_body and (
        i16 or not quirk or quirk_wave_exact(L, max_sub))
    libname = {(True, True): "sw_wave_i16", (True, False): "sw_forward_i16",
               (False, True): "sw_wave_i32",
               (False, False): "sw_forward"}[(bool(i16), wave)]
    lib = _kernels.load(libname)
    if i16:
        head = (profile.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
                col_mask.data_ptr(), B, n1, L, R, int(gapO), int(gapE))
        scratch = _scratch(lib, libname + "_scratch_per_pair", (B + 1) // 2,
                           L, dev)
    else:
        head = (profile.data_ptr(), ref.data_ptr(), read_len.data_ptr(),
                col_mask.data_ptr(), seg_id.data_ptr(), seg_start.data_ptr(),
                B, n1, L, R, int(gapO), int(gapE), int(bool(quirk)))
        scratch = _scratch(lib, libname + "_scratch_per_read", B, L, dev)
    # each library's C entry point, its owned-column variant with "_owned";
    # the column-scan bodies take the gate's arguments too
    fn = getattr(lib, _SHARED_ENTRY[libname] + ("_owned" if owned else ""))
    mid = ((*outs[:4], idx.data_ptr(), own.data_ptr()) if owned
           else (*outs, _ptr(wmask)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*head, *mid, _ptr(scratch), *(() if wave else (thr, hist)),
                stream)
    _raise_on(lib, rc, owned_kernel_name(i16) if owned else
              shared_kernel_name(i16, blockmax, wmask is not None))
    return (score, end_ref, end_read, maxcol), libname


_I16_CHECKED: set = set()  # card indices where the int16 tier passed
# launches of the int16 tier's parity probe, counted apart from LAUNCHES:
# they check the tier and compute nothing a caller reads
PARITY_LAUNCHES = {"_i16_parity": 0}


def i16_parity_inputs(dev):
    """The parity workload of _i16_parity on dev: forward_shared's
    arguments (profile, ref, read_len, col_mask, seg_id, seg_start, gapO,
    gapE, quirk) for 64 random DNA reads of 128 bp against 512 columns."""
    rng = np.random.default_rng(7)
    B, L, R = 64, 128, 512
    mat = np.full((5, 5), -2, np.int8)
    np.fill_diagonal(mat, 2)
    reads = rng.integers(0, 4, (B, L)).astype(np.int8)
    read_len = np.full(B, L, np.int32)
    prof = common.build_profile(reads, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=False)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return (t(prof), t(rng.integers(0, 4, R).astype(np.int32)), t(read_len),
            t(geo.col_mask), t(geo.seg_id), t(geo.seg_start), 3, 1, False)


def _i16_parity(dev):
    """Before the int16 tier first runs on a card, run both of its designs
    (the wavefront that ungated launches take and the column-scan body of
    the gated ones) and the int32 kernel on a fixed seeded workload inside
    the i16_exact bound and require identical outputs; raise if they
    differ.  This is the counterpart of the JAX package's _i16_supported
    probe, which gates its int16 tier on the same device parity check.
    Runs once per card; its launches count in PARITY_LAUNCHES, not in
    LAUNCHES."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key in _I16_CHECKED:
        return
    args = i16_parity_inputs(dev)
    want, _ = _launch_shared(*args, i16=False)
    PARITY_LAUNCHES["_i16_parity"] += 1
    for scan_body in (False, True):
        got, lib = _launch_shared(*args, i16=True, scan_body=scan_body)
        PARITY_LAUNCHES["_i16_parity"] += 1
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"the int16 tier of forward_shared ({lib}) "
                               f"disagrees with the int32 kernel on the "
                               f"parity workload")
    _I16_CHECKED.add(key)


def shared_kernel_name(i16: bool, blockmax: bool, dual: bool = False) -> str:
    """The LAUNCHES key of a forward_shared launch."""
    return ("forward_shared" + ("_i16" if i16 else "")
            + ("_dual" if dual else "_blockmax" if blockmax else ""))


def forward_shared(profile, ref, read_len, col_mask, seg_id, seg_start,
                   gapO: int, gapE: int, quirk: bool = True,
                   max_sub: int | None = None, blockmax: bool = False,
                   valid_len: int | None = None, wmask=None, gate=None,
                   scan_body: bool = False):
    """Batched forward DP against one shared target.  Returns (score,
    end_ref, end_read (B,) int32, maxcol (B, R) int16 in [0, 32767]).

    profile (B, n+1, L) int8, ref (R,) int32, read_len (B,) int32,
    col_mask/seg_start (B, L) bool, seg_id (B, L) int8.  max_sub =
    max|substitution score| runs the int16 tier when i16_exact allows it
    (counted as forward_shared_i16); the results are the same.

    blockmax: the last output is (B, ceil(R/256)) int32 per-block maxima
    over the columns < valid_len (default R), >= 0 and not clamped, and no
    (B, R) buffer is allocated; score/end_ref/end_read are unchanged
    (counted as forward_shared[_i16]_blockmax).

    wmask (B, L) bool, with blockmax and the quirk off: the dual tier.
    col_mask holds the byte tier's rows and wmask the word tier's, and the
    last output is (B, 2, ceil(R/256)): both tiers' block maxima from one
    pass (counted as forward_shared[_i16]_dual).

    gate: the bounded-radius gate's per-depth thresholds for K = L/32
    (ops/gate.py), or None; the results are the same (counted in GATED).
    Both tiers run the wavefront without the gate unless scan_body (or,
    int32 with the quirk, outside quirk_wave_exact), else the column-scan
    body (counted in LIBRARY)."""
    i16 = i16_exact(int(profile.shape[2]), gapO, gapE, max_sub, quirk)
    name = shared_kernel_name(i16, blockmax, wmask is not None)
    if profile.device.type == "cpu":
        res = scan_sw.forward_shared_ref(
            profile, ref, read_len, col_mask, seg_id, seg_start, gapO, gapE,
            quirk, blockmax=blockmax, valid_len=valid_len, wmask=wmask,
            gate=gate, pairs=i16, steps=gate is not None)
        return _count_plain_steps(res, gate)
    if i16:
        _i16_parity(profile.device)
    out, lib = _launch_shared(profile, ref, read_len, col_mask, seg_id,
                              seg_start, gapO, gapE, quirk, i16, blockmax,
                              valid_len, wmask, gate, scan_body=scan_body,
                              max_sub=max_sub)
    _count(name, lib, gate)
    return out


def owned_kernel_name(i16: bool) -> str:
    """The LAUNCHES key of a forward_shared_gated launch."""
    return "forward_shared" + ("_i16" if i16 else "") + "_owned"


def forward_shared_gated(profile, ref, idx, own, read_len, col_mask, seg_id,
                         seg_start, gapO: int, gapE: int, quirk: bool = True,
                         max_sub: int | None = None, gate=None,
                         scan_body: bool = False):
    """forward_shared in the owned-column mode, the counterpart of the JAX
    package's forward_shared_ref_gated (the sequence-parallel shards of
    parallel/dist.py): idx (R,) int32 is each local column's global index
    and own (R,) bool says which columns may take a new best hit; end_ref
    is the global index of the best column.  Returns (score, end_ref,
    end_read (B,) int32, maxcol (B, R) int16 in [0, 32767]) with maxima for
    every local column.  The int16 tier under the same i16_exact rule
    (counted as forward_shared_i16_owned, else forward_shared_owned), and
    gate= and scan_body= as forward_shared's (the bounded-radius gate)."""
    i16 = i16_exact(int(profile.shape[2]), gapO, gapE, max_sub, quirk)
    name = owned_kernel_name(i16)
    if profile.device.type == "cpu":
        res = scan_sw.forward_shared_ref_gated(
            profile, ref, idx, own, read_len, col_mask, seg_id, seg_start,
            gapO, gapE, quirk, gate=gate, pairs=i16, steps=gate is not None)
        return _count_plain_steps(res, gate)
    if i16:
        _i16_parity(profile.device)
    out, lib = _launch_shared(profile, ref, read_len, col_mask, seg_id,
                              seg_start, gapO, gapE, quirk, i16, gate=gate,
                              idx=idx, own=own, scan_body=scan_body,
                              max_sub=max_sub)
    _count(name, lib, gate)
    return out


def _count(name, lib, gate):
    """Count one successful launch of kernel `name` by library `lib`."""
    LAUNCHES[name] += 1
    if gate is not None:
        GATED[name] += 1
    LIBRARY[lib] += 1


def _count_plain_steps(res, gate):
    """A plain version's outputs; its gate steps go to the CPU histogram."""
    if gate is None:
        return res
    out, hist = res
    _steps(hist.device).add_(hist)
    return out


_SHAPES: dict = {}  # (lanes, n1, quirk, dual, card) -> (wpb, resident)


def packed_shape(lanes: int, n1: int, quirk: bool, dual: bool, dev):
    """(warps per block, resident warps per SM) of the packed wavefront's
    variant for `lanes` lanes per warp and this mode on card `dev` (the
    library's sw_wave_packed_shape)."""
    key = (lanes, n1, bool(quirk), bool(dual), str(dev))
    if key not in _SHAPES:
        lib = _kernels.load("sw_wave_packed")
        shape = (ctypes.c_int * 2)()
        with torch.cuda.device(dev):
            rc = lib.sw_wave_packed_shape(lanes, n1, int(bool(quirk)),
                                          int(bool(dual)), shape)
        _raise_on(lib, rc, "sw_wave_packed_shape")
        _SHAPES[key] = (shape[0], shape[1])
    return _SHAPES[key]


def _sm_count(dev) -> int:
    """Streaming multiprocessors of `dev` (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(dev).multi_processor_count


def packed_launch(B: int, slot_max: int, n1: int, valid_len: int,
                  max_sub, gapO: int, gapE: int, quirk: bool, dual: bool,
                  dev, gate=None, scan_body: bool = False):
    """(P, C, halo, blocks) of the forward_shared_packed launch these
    arguments make: P stretches per read of C columns, each after halo
    warm-up columns, in `blocks` blocks.  The wavefront's P follows
    pack.stretch_rule from the reads, packed_shape's warps per block, the
    card's SMs, the columns and the halo; a gated or scan_body launch, and
    any launch off a card, runs P = 1 (blocks: the column-scan body's four
    warps a block).  The wrapper launches exactly this, and
    pipeline._forward_waves counts these blocks."""
    vl = max(int(valid_len), 0)
    lanes = pack.packed_lanes(slot_max)
    if gate is not None or scan_body or dev.type != "cuda":
        return 1, pack.stretch_bounds(vl, 1)[1], 0, -(-B // 4)
    wpb = packed_shape(lanes, n1, quirk, dual, dev)[0]
    halo = pack.stretch_halo(lanes, max_sub, gapO, gapE)
    P, C = pack.stretch_bounds(vl, pack.stretch_rule(
        B, wpb, _sm_count(dev), vl, halo))
    return P, C, halo if P > 1 else 0, -(-B * P // wpb)


def forward_shared_packed(profile, ref, so, sl, rl_s, flat_idx, gapO: int,
                          gapE: int, max_sub: int | None = None,
                          valid_len: int | None = None, quirk: bool = False,
                          word: bool = False, dual: bool = False,
                          slot_max: int | None = None, gate=None,
                          scan_body: bool = False):
    """Forward DP of lane-packed reads (ops/pack.py) against one shared
    target, always int32, in blockmax mode.  profile (n_rows, n+1, W) int8
    over the packed codes, ref (R,) int32, so/sl/rl_s (n_rows, S) int32
    slot tables, flat_idx (B,) int32 = row * S + slot.  Returns per read
    (score, end_ref, end_read) (B,) int32 and block maxima over the columns
    < valid_len (at most R) (B, ceil(R/256)) int32, or (B, 2, ceil(R/256))
    with dual (byte tier, then word); only those columns feed the best hit.
    quirk: the lane-block E quirk (word: its 8-block geometry), within the
    QBUMP span guard (pack.check_quirk_span raises outside it).  slot_max:
    the longest slot, max(sl), when the caller knows it (else read from sl,
    a device sync).  gate: per-depth thresholds for K =
    pack.packed_lanes(slot_max)/32 (ops/gate.py).  Without the gate the
    wavefront runs (sw_wave_packed) unless scan_body, else the column-scan
    body (sw_forward_packed).  The wavefront splits the target into
    stretches, one warp each, as packed_launch says; the outputs are the
    same.  Counted as forward_shared_packed[_dual] (and in GATED with gate=,
    in LIBRARY by library, in SPLIT with P > 1), and on a card its warps,
    B * P, in the profiling counter `forward_stretches`."""
    if profile.device.type == "cpu":
        res = scan_sw.forward_shared_ref_packed(
            profile, ref, so, sl, rl_s, flat_idx, gapO, gapE,
            max_sub=max_sub, valid_len=valid_len, quirk=quirk, word=word,
            dual=dual, gate=gate, steps=gate is not None)
        return _count_plain_steps(res, gate)
    if dual and quirk:
        raise ValueError("the dual tier needs the quirk off")
    if slot_max is None:
        slot_max = pack.slot_max(sl)
    if quirk:
        pack.check_quirk_span(slot_max, max_sub, gapO, gapE)
    dev = profile.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with tensors on {dev}")
    n_rows, n1, W = profile.shape
    S = int(so.shape[1])
    B = int(flat_idx.shape[0])
    R = int(ref.shape[0])
    _check("profile", profile, torch.int8, (n_rows, n1, W), dev)
    _check("ref", ref, torch.int32, (R,), dev)
    for name, x in (("so", so), ("sl", sl), ("rl_s", rl_s)):
        _check(name, x, torch.int32, (n_rows, S), dev)
    _check("flat_idx", flat_idx, torch.int32, (B,), dev)
    Lw = pack.packed_lanes(slot_max)
    vl = R if valid_len is None else min(int(valid_len), R)
    nblk = (R + scan_sw.BM - 1) // scan_sw.BM
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_ref = torch.empty(B, dtype=torch.int32, device=dev)
    end_read = torch.empty(B, dtype=torch.int32, device=dev)
    maxcol = torch.empty((B, 2, nblk) if dual else (B, nblk),
                         dtype=torch.int32, device=dev)
    libname = ("sw_wave_packed" if gate is None and not scan_body
               else "sw_forward_packed")
    lib = _kernels.load(libname)
    P, C, halo, _ = packed_launch(B, slot_max, n1, vl, max_sub, gapO, gapE,
                                  quirk, dual, dev, gate, scan_body)
    n = getattr(lib, libname + "_scratch_per_read")(Lw, n1)
    scratch = (torch.empty((B * P, n), dtype=torch.int32, device=dev)
               if n else None)
    part = (torch.empty((3, B * P), dtype=torch.int32, device=dev)
            if P > 1 else None)
    head = (profile.data_ptr(), ref.data_ptr(), so.data_ptr(), sl.data_ptr(),
            rl_s.data_ptr(), flat_idx.data_ptr(), B, n1, W, S, Lw, R, vl,
            int(gapO), int(gapE), int(bool(quirk)), 8 if word else 16,
            int(bool(dual)), score.data_ptr(), end_ref.data_ptr(),
            end_read.data_ptr(), maxcol.data_ptr(), _ptr(scratch))
    thr, hist = _gate_args(gate, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if libname == "sw_wave_packed":
            rc = lib.sw_wave_packed(*head, P, C, halo, _ptr(part), stream)
        else:
            rc = lib.sw_forward_packed(*head, thr, hist, stream)
    name = "forward_shared_packed" + ("_dual" if dual else "")
    _raise_on(lib, rc, name)
    _count(name, libname, gate)
    if P > 1:
        SPLIT[name] += 1
    profiling.count("forward_stretches", B * P)
    return score, end_ref, end_read, maxcol


def forward_perread(profile, refw, read_len, col_mask, seg_id, seg_start,
                    gapO: int, gapE: int, quirk: bool = True,
                    terminate=None, emit_maxcol: bool = False,
                    scan_body: bool = False):
    """Forward DP over per-read windows refw (B, W) int32, with the
    terminate-at-score1 break (terminate (B,) int32, -1 = never).  Returns
    (score, end_ref, end_read) (+ maxcol (B, W) int32 with emit_maxcol).
    The wavefront runs (sw_wave_perread) unless scan_body (or, with the
    quirk, outside quirk_wave_exact), else the column-scan body
    (sw_perread; counted in LIBRARY)."""
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
    libname = ("sw_wave_perread" if not scan_body and (
        not quirk or quirk_wave_exact(L, None)) else "sw_perread")
    lib = _kernels.load(libname)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_ref = torch.empty(B, dtype=torch.int32, device=dev)
    end_read = torch.empty(B, dtype=torch.int32, device=dev)
    maxcol = (torch.empty((B, W), dtype=torch.int32, device=dev)
              if emit_maxcol else None)
    scratch = _scratch(lib, libname + "_scratch_per_read", B, L, dev)
    fn = (lib.sw_wave_perread if libname == "sw_wave_perread"
          else lib.sw_forward_perread)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            profile.data_ptr(), refw.data_ptr(), _ptr(terminate),
            read_len.data_ptr(), col_mask.data_ptr(), seg_id.data_ptr(),
            seg_start.data_ptr(), B, n1, L, W, int(gapO), int(gapE),
            int(bool(quirk)), score.data_ptr(), end_ref.data_ptr(),
            end_read.data_ptr(), _ptr(maxcol), _ptr(scratch), stream)
    _raise_on(lib, rc, "forward_perread")
    _count("forward_perread", libname, None)
    out = (score, end_ref, end_read)
    return out + (maxcol,) if emit_maxcol else out


def reset_launches():
    """Set LAUNCHES, GATED, LIBRARY, SPLIT and PARITY_LAUNCHES to 0."""
    for counts in (LAUNCHES, GATED, LIBRARY, SPLIT, PARITY_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def gated_counts() -> dict:
    return dict(GATED)


def library_counts() -> dict:
    return dict(LIBRARY)


def split_counts() -> dict:
    return dict(SPLIT)


def parity_counts() -> dict:
    return dict(PARITY_LAUNCHES)


def reset_gate_steps():
    for hist in _STEPS.values():
        hist.zero_()


def gate_steps() -> list[int]:
    """Warp-column steps of the gated launches (and of the plain versions
    on the CPU) by scan depth 0..5 since reset_gate_steps, summed over
    devices; reading a card's histogram synchronises it."""
    total = [0] * (gate_mod.DEPTHS + 1)
    for hist in _STEPS.values():
        for m, n in enumerate(hist.tolist()):
            total[m] += n
    return total
