"""Reproducer of the int16 forward kernel's K = 14 fault (ROADMAP §C).

Appending 40 bytes that no device code reads to the int16 kernel's
argument struct (`I16Args` in csrc/sw_forward_i16.cu) made the ungated
base-mode kernel at K = 14 (`sw_forward_i16_kernel<14, false, false,
false>`) return wrong maxima, scores and ends for the low half of every
read pair on one input.  The production source keeps the struct as it is
(the gate and the owned columns are extra kernel parameters instead).
This script rebuilds that variant into ssw_tpu_torch/build/i16_fault/ and
shows the fault and where it goes:

  * production source, ptxas -O3 (the default), and the variant at ptxas
    -O3, -O2, -O1 and -O0, each on the failing input: the chip_smoke.py
    phase-3 case `shared L=448 gapO=3 gapE=1 quirk=False word=False` (seed
    106, B 43, R 778) against the plain twin;
  * how the K = 14 kernel's PTX (nvcc -ptx) of each source reads its
    argument struct: at 120 bytes every field is an ld.param at a fixed
    offset of the parameter; at 160 bytes NVVM takes the parameter's
    address (mov.b64 %rd, param) and loads fields through registers
    (ld.param [%rd + offset]).  The tail's PTX is one program, right at
    ptxas -O1 and -O0 and wrong at -O2 and -O3;
  * registers (ptxas -v) and SASS instruction counts of the kernel in each
    build;
  * whether the wrong outputs depend on the run or on the tail's value
    (set on the host to 0, -1 and 0x5A5A5A5A), and whether passing the
    struct as a __grid_constant__ parameter changes them;
  * device-global dumps (col_mask bits before and after the column loop,
    the DP state of the first columns, the final rows and best hits)
    against the plain twin, in builds that add the stores; the stores
    change the register allocation, and most of those builds come out
    right;
  * which plain-twin change reproduces all four outputs of a wrong build
    exactly (faulted_twin: E at one position k of every thread, in one
    half of each pair, decaying by gapE + 1), and the SASS that makes E's
    decay (each E update adds -gapE per half with VIADD.16x2; the wrong
    build rebuilds that constant for one k as VIADD.16x2 of ~gapE and 0
    joined by a PRMT, so the low half adds ~gapE = -gapE - 1).

    python -m ssw_tpu_torch.tools.i16_fault     # needs the card and nvcc
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from ssw_tpu_torch.ops import _kernels, cuda_sw, scan_sw
from ssw_tpu_torch.tools import _common

OUT = os.path.join(_kernels.BUILD, "i16_fault")
KERNEL = "sw_forward_i16_kernelILi14ELb0ELb0ELb0E"
TAIL = ("  int gate;\n  int gate_thr[5];\n"
        "  unsigned long long* gate_hist;\n  int gate_pad[2];\n")
_LAST = ("  unsigned* scratch;        // (ceil(B/2), 4, L) for PGlobRow, "
         "else null\n};")
_INIT = "  a.scratch = static_cast<unsigned*>(scratch);\n"
_GLOBAL = ("__global__ void sw_forward_i16_kernel(const I16Args a, "
           "const sw::GateArgs g) {")
_MASKED = ("    r.set_mask(k, cma[j] != 0, has_b && cma[L + j] != 0);\n"
           "  }\n")
_COLUMN = "    const int ca = lo16(cm), cb = hi16(cm);\n"
FILL_ENV = "SW_I16_TAIL_FILL"
# the dumps of the "d*" builds: pairs, columns of state, columns of maxima
DP, DC, DM = 32, 32, 1024
DUMP = f"""
__device__ unsigned g_dbg_state[{DP}][{DC}][32][2][16];  // pair col t H/E k
__device__ unsigned g_dbg_cm[{DP}][{DM}];  // pair col: packed column max
__device__ unsigned g_dbg_mask[{DP}][32][2];  // pair t: cma cmb, before
__device__ unsigned g_dbg_end[{DP}][32][3][16];  // pair t H/E/HB k, after
__device__ unsigned g_dbg_mask_end[{DP}][32][2];  // pair t: cma cmb, after
__device__ int g_dbg_best[{DP}][4];  // pair: gmax_a gmax_b er_a er_b
"""
_DUMP_MASK = """  if constexpr (KT > 0) {
    if (pair < %d) {
      g_dbg_mask[pair][t][0] = r.cma;
      g_dbg_mask[pair][t][1] = r.cmb;
    }
  }
""" % DP
_DUMP_COLUMN = """    if (pair < %d) {
      if (t == 0 && col < %d) g_dbg_cm[pair][col] = cm;
      if (col < %d)
        for (int k = 0; k < KK && k < 16; ++k) {
          g_dbg_state[pair][col][t][0][k] = r.H(k);
          g_dbg_state[pair][col][t][1][k] = r.E(k);
        }
    }
""" % (DP, DM, DC)
_FLUSH = "  if constexpr (Gate) sw::gate_flush(g, t, steps);\n"
_DUMP_END = """  if constexpr (KT > 0) {
    if (pair < %d) {
      for (int k = 0; k < KK && k < 16; ++k) {
        g_dbg_end[pair][t][0][k] = r.H(k);
        g_dbg_end[pair][t][1][k] = r.E(k);
        g_dbg_end[pair][t][2][k] = r.HB(k);
      }
      g_dbg_mask_end[pair][t][0] = r.cma;
      g_dbg_mask_end[pair][t][1] = r.cmb;
      if (t == 0) {
        g_dbg_best[pair][0] = gmax_a;
        g_dbg_best[pair][1] = gmax_b;
        g_dbg_best[pair][2] = er_a;
        g_dbg_best[pair][3] = er_b;
      }
    }
  }
""" % DP
_DUMP_HOST = """
extern "C" int i16_fault_dump(void* state, void* cm, void* mask, void* end,
                              void* mask_end, void* best) {
  cudaError_t e = cudaMemcpyFromSymbol(state, g_dbg_state,
                                       sizeof(g_dbg_state));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(cm, g_dbg_cm, sizeof(g_dbg_cm));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(mask, g_dbg_mask, sizeof(g_dbg_mask));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(end, g_dbg_end, sizeof(g_dbg_end));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(mask_end, g_dbg_mask_end,
                             sizeof(g_dbg_mask_end));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(best, g_dbg_best, sizeof(g_dbg_best));
  return int(e);
}
"""
# (name, edits of the copy, ptxas level): "tail" appends the 40 bytes,
# "gc" passes the struct as a __grid_constant__ parameter; the dumps to
# device globals: "dmask" each thread's col_mask bits before the column
# loop, "dcol" the pairs' H and E after each of the first DC columns and
# the column maxima, "dend" the H, E, HB rows, mask bits and best hits
# after the loop
BUILDS = (("production_O3", (), 3), ("tail_O3", ("tail",), 3),
          ("tail_O2", ("tail",), 2), ("tail_O1", ("tail",), 1),
          ("tail_O0", ("tail",), 0), ("tail_gc_O3", ("tail", "gc"), 3),
          ("tail_dcol_O3", ("tail", "dmask", "dcol"), 3),
          ("tail_dmask_O3", ("tail", "dmask"), 3),
          ("tail_dend_O3", ("tail", "dend"), 3),
          ("tail_dend_O1", ("tail", "dend"), 1))
DUMPED = ("tail_dcol_O3", "tail_dmask_O3", "tail_dend_O3", "tail_dend_O1")
FILLS = (0, 0, 0, -1, 0x5A5A5A5A)


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"sw_forward_i16.cu no longer has {old.strip()!r}"
                           f", which this reproducer edits")
    return src.replace(old, new)


def edited_source(dst: str, edits) -> str:
    """A copy of csrc/ in dst with the edits of BUILDS applied to
    sw_forward_i16.cu; returns the copy's .cu path.  The tail is set on the
    host to $SW_I16_TAIL_FILL (0 when unset) and read by no kernel."""
    os.makedirs(dst, exist_ok=True)
    for f in os.listdir(_kernels.CSRC):
        shutil.copy(os.path.join(_kernels.CSRC, f), dst)
    path = os.path.join(dst, "sw_forward_i16.cu")
    src = open(path).read()
    if "tail" in edits:
        src = _edit(src, _LAST, _LAST[:_LAST.index("};")] + TAIL + "};\n"
                    "static_assert(sizeof(I16Args) == 160, \"tail\");")
        src = _edit(src, _INIT, _INIT + (
            f"  const char* fill_s = getenv(\"{FILL_ENV}\");\n"
            "  const int fill = fill_s ? atoi(fill_s) : 0;\n"
            "  a.gate = fill;\n  for (int m = 0; m < 5; ++m) "
            "a.gate_thr[m] = fill;\n"
            "  a.gate_hist = reinterpret_cast<unsigned long long*>("
            "intptr_t(fill));\n  a.gate_pad[0] = a.gate_pad[1] = fill;\n"))
        src = "#include <cstdint>\n#include <cstdlib>\n" + src
    if "gc" in edits:
        src = _edit(src, _GLOBAL, _GLOBAL.replace(
            "(const I16Args a", "(const __grid_constant__ I16Args a"))
    if {"dmask", "dcol", "dend"} & set(edits):
        src = _edit(src, "struct I16Args {", DUMP + "struct I16Args {")
        src += _DUMP_HOST
    if "dmask" in edits:
        src = _edit(src, _MASKED, _MASKED + _DUMP_MASK)
    if "dcol" in edits:
        src = _edit(src, _COLUMN, _COLUMN + _DUMP_COLUMN)
    if "dend" in edits:
        src = _edit(src, _FLUSH, _DUMP_END + _FLUSH)
    open(path, "w").write(src)
    return path


def _nvcc(src, out, extra):
    cmd = [_kernels.nvcc_path(), _kernels.ARCH, "-std=c++17", "-O3",
           *extra, "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def build_all() -> dict:
    """Every build of BUILDS and the PTX of the production and tail
    sources, all nvcc runs at once; returns {name: ptxas -v log}."""
    os.makedirs(OUT, exist_ok=True)
    srcs = {}
    for _, edits, _ in BUILDS:
        if edits not in srcs:
            srcs[edits] = (os.path.join(_kernels.CSRC, "sw_forward_i16.cu")
                           if not edits else edited_source(os.path.join(
                               OUT, "csrc_" + "_".join(edits)), edits))
    procs = {}
    for name, edits, level in BUILDS:
        procs[name] = _nvcc(srcs[edits], os.path.join(OUT, f"lib{name}.so"),
                            ["-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                             "-v", "-Xptxas", f"-O{level}"])
    for tail, edits in ((0, ()), (1, ("tail",))):
        procs[f"ptx_{tail}"] = _nvcc(
            srcs[edits], os.path.join(OUT, f"k{tail}.ptx"), ["-ptx"])
    logs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{err}")
        logs[name] = err
    return logs


def ptx_body(path: str) -> tuple[list, list]:
    """The K = 14 kernel's PTX: (parameter declarations, the other
    lines)."""
    params, body, on = [], [], False
    for line in open(path).read().splitlines():
        if ".entry" in line:
            on = KERNEL in line
        if not on:
            continue
        (params if ".param" in line else body).append(line.strip())
        if line == "}":
            break
    return params, body


def failing_input(dev, seed=106):
    """The failing input (seed 106), or another seed of its shape: B 43,
    L 448, R 778, DNA +2/-2, byte geometry, from chip_smoke.py's phase-3
    generator (_common.shared_case)."""
    mat = np.zeros((5, 5), np.int8)
    mat[:4, :4] = -2
    np.fill_diagonal(mat[:4, :4], 2)
    return _common.shared_case(dev, B=43, L=448, R=778, mat=mat, word=False,
                               seed=seed)[0]


NAMES = ("score", "end_ref", "end_read", "maxcol")


def load(name):
    lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
    for fn, argtypes in _kernels._SIGNATURES["sw_forward_i16"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.sw_error_string.argtypes = [ctypes.c_int]
    lib.sw_error_string.restype = ctypes.c_char_p
    return lib


def launch(name, args, fill=0) -> list:
    """The int16 tier of library lib<name>.so on args, the tail set to
    fill: (score, end_ref, end_read, maxcol)."""
    os.environ[FILL_ENV] = str(fill)
    saved = _kernels._libs.get("sw_forward_i16")
    _kernels._libs["sw_forward_i16"] = load(name)
    try:
        got, _ = cuda_sw._launch_shared(*args, 3, 1, False, i16=True,
                                        scan_body=True)
    finally:
        os.environ.pop(FILL_ENV)
        if saved is None:
            _kernels._libs.pop("sw_forward_i16")
        else:
            _kernels._libs["sw_forward_i16"] = saved
    torch.cuda.synchronize()
    return list(got)


def compare(got, want) -> dict:
    """max |error| per output, the rows and first column of maxcol that
    differ."""
    res = {n: int((g.long() - w.long()).abs().max()) for n, g, w in
           zip(NAMES, got, want)}
    bad = got[3] != want[3]
    if bad.any():
        rows = bad.any(1).nonzero().flatten().tolist()
        res["bad_rows"] = ("all even" if rows == list(range(0, 43, 2))
                           else rows)
        res["first_bad_column"] = int(bad.any(0).nonzero()[0])
    return res


def dump(name, args) -> dict:
    """A "d*" build's run on args: its outputs and the device globals its
    edits write (zeros where they write none), per pair p (read 2p in the
    low, 2p+1 in the high half) and thread t (positions t*K + k)."""
    got = launch(name, args)
    lib = load(name)
    d = {"state": np.zeros((DP, DC, 32, 2, 16), np.uint32),
         "cm": np.zeros((DP, DM), np.uint32),
         "mask": np.zeros((DP, 32, 2), np.uint32),
         "end": np.zeros((DP, 32, 3, 16), np.uint32),
         "mask_end": np.zeros((DP, 32, 2), np.uint32),
         "best": np.zeros((DP, 4), np.int32)}
    rc = lib.i16_fault_dump(*(ctypes.c_void_p(a.ctypes.data)
                              for a in d.values()))
    _common.raise_on(lib, rc, f"i16_fault_dump {name}")
    return {"out": got, **d}


def plain_run(args) -> dict:
    """The plain twin column by column (scan_sw's update, quirk off): H
    after every column (R, B, L), E after the first DC, and the final H,
    E, h_best rows, score and end_ref."""
    prof, ref, _, cm, seg, ss = [a.cpu() for a in args]
    b, _, l = prof.shape
    prof_t = prof.to(torch.int32).permute(1, 0, 2).contiguous()
    decay, bias, reset = scan_sw._geometry(seg, ss, l, 1, "cpu")
    st = scan_sw._init_state(b, l, "cpu")
    H, E = [], []
    for j, code in enumerate(ref.tolist()):
        st, _ = scan_sw._column_update(prof_t[code], st, 3, 1, decay, bias,
                                       reset, cm.to(torch.bool), j,
                                       quirk=False)
        H.append(st[0].numpy())
        if j < DC:
            E.append(st[1].numpy())
    return {"H": np.stack(H), "E": np.stack(E),
            "end": np.stack([st[0].numpy(), st[1].numpy(), st[4].numpy()]),
            "gmax": st[2].numpy(), "end_ref": st[3].numpy()}


def _halves(v: np.ndarray) -> np.ndarray:
    """Packed pairs uint32 (...) -> int16 (..., 2): (low, high)."""
    return np.stack([(v & 0xFFFF).astype(np.uint16).view(np.int16),
                     (v >> 16).astype(np.uint16).view(np.int16)], -1)


def _layout(a: np.ndarray, B: int, K: int) -> np.ndarray:
    """(..., B, L) per read -> (..., pairs, 32, K, 2), the kernel's
    (pair, thread, k, half) layout."""
    pairs = (B + 1) // 2
    pad = np.zeros(a.shape[:-2] + (2 * pairs, a.shape[-1]), a.dtype)
    pad[..., :B, :] = a
    x = pad.reshape(a.shape[:-2] + (pairs, 2, 32, K))
    return np.moveaxis(x, -3, -1)


def _first(diff_idx, names, got, want) -> dict | None:
    if not len(diff_idx):
        return None
    i = tuple(diff_idx[0])
    return {**{n: int(x) for n, x in zip(names, i)}, "got": int(got[i]),
            "plain": int(want[i])}


def dump_report(d: dict, args, plain: dict, edits) -> dict:
    """What the dumps of one "d*" build say against the plain twin: the
    col_mask bits before and after the loop, the H and E of the first DC
    columns (and the first value that differs, in column order), the
    column maxima, and the final rows and best hits; per half."""
    B, L = int(args[0].shape[0]), int(args[0].shape[2])
    K, pairs = L // 32, (B + 1) // 2
    R = int(args[1].numel())
    cmask = _layout(args[3].cpu().numpy().astype(np.int64), B, K)
    bits = (cmask << np.arange(K)[:, None]).sum(-2)  # pairs 32 half
    rep = {}
    for key in ("mask", "mask_end"):
        if ("dmask" if key == "mask" else "dend") in edits:
            rep[key + "_bad_threads"] = int(
                (d[key][:pairs].astype(np.int64) != bits).any(-1).sum())
    if "dcol" in edits:
        got = _halves(d["state"][:pairs, :, :, :, :K])  # p c t f k h
        want = np.stack([_layout(plain["H"][:DC], B, K),
                         _layout(plain["E"], B, K)], 2)  # c p f t k h
        want = want.transpose(1, 0, 3, 2, 4, 5)
        ne = got != want
        rep["state_bad_by_half"] = [int(ne[..., 0].sum()),
                                    int(ne[..., 1].sum())]
        idx = np.argwhere(ne)
        idx = idx[np.lexsort(idx.T[[5, 3, 4, 2, 0, 1]])]
        rep["first_state_diff"] = _first(
            idx, ("pair", "column", "thread", "field_HE", "k", "half"),
            got, want)
        cols = min(R, DM)
        colmax = np.where(args[3].cpu().numpy()[None], plain["H"][:cols],
                          0).max(-1)  # c B
        gotc = _halves(d["cm"][:pairs, :cols])  # p c h
        wantc = np.zeros((cols, 2 * pairs), np.int64)
        wantc[:, :B] = colmax
        wantc = wantc.reshape(cols, pairs, 2).transpose(1, 0, 2)
        rep["column_max_bad_by_half"] = [
            int((gotc[..., h] != wantc[..., h]).sum()) for h in (0, 1)]
    if "dend" in edits:
        got = _halves(d["end"][:pairs, :, :, :K])  # p t f k h
        want = _layout(plain["end"], B, K).transpose(1, 2, 0, 3, 4)
        ne = got != want
        rep["end_rows_bad_by_field_half"] = {
            f: [int(ne[:, :, i, :, 0].sum()), int(ne[:, :, i, :, 1].sum())]
            for i, f in enumerate(("H", "E", "HB"))}
        rep["first_end_diff"] = _first(
            np.argwhere(ne), ("pair", "thread", "field_H_E_HB", "k", "half"),
            got, want)
        best = d["best"][:pairs]
        g = np.zeros(2 * pairs, np.int64)
        g[:B] = plain["gmax"]
        e = np.full(2 * pairs, -1, np.int64)
        e[:B] = plain["end_ref"]
        rep["best_bad_by_half"] = {
            "gmax": [int((best[:, h] != g[h::2]).sum()) for h in (0, 1)],
            "end_ref": [int((best[:, 2 + h] != e[h::2]).sum())
                        for h in (0, 1)]}
    return rep


def static_mask_fit(got, args, plain: dict) -> dict:
    """Does a col_mask that drops a fixed set of positions explain every
    maxcol cell of the reads the build got wrong?  Per such read: the
    masked positions whose plain H exceeds the written maximum in some
    column (they must have been dropped), as (thread, k) with positions
    t*K + k, and whether the maximum over the rest equals every column."""
    mc = got[3].cpu().numpy().astype(np.int64)
    cm = args[3].cpu().numpy()
    H = plain["H"]  # R B L
    K = H.shape[-1] // 32
    right = np.where(cm[None], H, 0).max(-1).T
    rows = np.nonzero((mc != right).any(1))[0]
    fits, ks = {}, collections.Counter()
    for b in rows:
        over = (H[:, b, :] > mc[b][:, None]).any(0) & cm[b]
        keep = cm[b] & ~over
        fit = bool((np.where(keep[None], H[:, b, :], 0).max(-1)
                    == mc[b]).all())
        drop = np.nonzero(over)[0]
        ks.update(int(p % K) for p in drop)
        fits[int(b)] = {"fits": fit, "dropped": len(drop),
                        "valid": int(cm[b].sum()),
                        "dropped_t_k": [(int(p // K), int(p % K))
                                        for p in drop[:12]]}
    return {"rows_fit": sum(f["fits"] for f in fits.values()),
            "rows": len(rows), "dropped_by_k": dict(sorted(ks.items())),
            "per_row": {b: fits[b] for b in list(fits)[:4]}}


def faulted_twin(args, k: int, half: int) -> list:
    """The plain twin with one change: E at positions t*K + k of the reads
    in `half` of each pair (0: low, even reads) decays by gapE + 1 a column
    where it should decay by gapE.  (score, end_ref, end_read, maxcol)."""
    prof, ref, rl, cm, seg, ss = args
    b, _, l = prof.shape
    dev = prof.device
    prof_t = prof.to(torch.int32).permute(1, 0, 2).contiguous()
    decay, bias, reset = scan_sw._geometry(seg, ss, l, 1, dev)
    extra = torch.zeros((b, l), dtype=torch.int32, device=dev)
    extra[half::2, k::l // 32] = 1
    st = scan_sw._init_state(b, l, dev)
    mc = []
    for j, code in enumerate(ref.tolist()):
        E = st[1]
        st, colmax = scan_sw._column_update(
            prof_t[code], st, 3, 1, decay, bias, reset, cm.to(torch.bool), j,
            quirk=False)
        E = torch.maximum(E - 1 - extra, st[0] - 3).clamp_min_(0)
        st = (st[0], E) + st[2:]
        mc.append(colmax)
    out = scan_sw._finalize(st, rl, l)
    return [*out, torch.stack(mc).t().clamp_max(32767).to(torch.int16)]


def fault_model(got, args) -> list:
    """Every (k, half) whose faulted_twin equals all four outputs of a
    wrong build."""
    K = int(args[0].shape[2]) // 32
    return [{"k": k, "half": "low" if h == 0 else "high"}
            for h in (0, 1) for k in range(K)
            if all(torch.equal(g.long(), w.long()) for g, w in
                   zip(got, faulted_twin(args, k, h)))]


def sass_lines(path, pattern) -> list:
    """The K = 14 base kernel's SASS instructions in library path that
    match the regular expression pattern, with their addresses."""
    cuobj = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobj, "-sass", path], capture_output=True,
                          text=True).stdout
    out, on = [], False
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            on = KERNEL in m.group(1) and "owned" not in m.group(1)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if on and m and re.search(pattern, m.group(2)):
            out.append(f"{m.group(1)} {' '.join(m.group(2).split())}")
    return out


def maxcol_hypotheses(got, args, plain: dict) -> dict:
    """Which column maximum the wrong build wrote for the reads it got
    wrong: of its wrong maxcol cells, how many equal the masked maximum of
    the plain H with one of the thread's K positions left out (per k),
    the unmasked maximum, the previous column's, or the pair's other
    read's mask applied."""
    mc = got[3].cpu().numpy().astype(np.int64)
    cm = args[3].cpu().numpy()
    H = plain["H"]  # R B L
    right = np.where(cm[None], H, 0).max(-1).T  # B R
    bad = mc != right
    if not bad.any():
        return {"wrong_cells": 0}
    K = H.shape[-1] // 32
    out = {"wrong_cells": int(bad.sum()),
           "wrong_low": int(bad[0::2].sum()),
           "wrong_high": int(bad[1::2].sum()),
           "got_below_plain": int((mc < right)[bad].sum())}
    nomask = H.max(-1).T
    prev = np.concatenate([np.zeros_like(right[:, :1]), right[:, :-1]], 1)
    other = np.roll(cm, -1, 0)  # read b's mask on read a (b = a + 1)
    swapped = np.where(other[None], H, 0).max(-1).T
    for name, h in (("unmasked", nomask), ("previous_column", prev),
                    ("other_reads_mask", swapped)):
        out[name] = int((mc == h)[bad].sum())
    skip = {}
    pos = np.arange(H.shape[-1]) % K
    for k in range(K):
        h = np.where((cm & (pos != k))[None], H, 0).max(-1).T
        skip[k] = int((mc == h)[bad].sum())
    out["without_position_k"] = skip
    return out


def sass_ops(path) -> collections.Counter:
    """Instruction counts of the K = 14 base kernel's SASS in library
    path."""
    cuobj = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobj, "-sass", path], capture_output=True,
                          text=True).stdout
    ops, on = collections.Counter(), False
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            on = KERNEL in m.group(1) and "owned" not in m.group(1)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if on and m:
            ops[m.group(1)] += 1
    return ops


def main(argv=None) -> int:
    dev = _common.resolve_device(None)
    logs = build_all()
    ver = subprocess.run([_kernels.nvcc_path(), "--version"],
                         capture_output=True, text=True).stdout
    print("nvcc:", ver.strip().splitlines()[-1])
    print(f"card: {torch.cuda.get_device_name(dev)}; nvidia-smi: "
          f"{_common.card_line()}")
    for tail in (0, 1):
        params, body = ptx_body(os.path.join(OUT, f"k{tail}.ptx"))
        loads = [x for x in params if x.startswith("ld.param")]
        print(json.dumps({
            "ptx": "tail" if tail else "production",
            "param_bytes": re.findall(r"param_0\[(\d+)\]", " ".join(params)),
            "kernel_lines": len(params) + len(body),
            "ld_param_fixed_offset": sum("[_Z" in x for x in loads),
            "ld_param_through_register": sum("[%rd" in x for x in loads),
            "param_address_taken": any(x.startswith("mov.b64") and "_param_0"
                                       in x for x in body)}))
    args = failing_input(dev)
    want = scan_sw.forward_shared_ref(*args, 3, 1, False)
    torch.cuda.synchronize()
    for name, edits, level in BUILDS:
        regs = re.findall(rf"{KERNEL}[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) "
                          r"registers", logs[name])
        ops = sass_ops(os.path.join(OUT, f"lib{name}.so"))
        res = compare(launch(name, args), want)
        ok = not any(res[k] for k in NAMES)
        print(json.dumps({"build": name, "edits": list(edits),
                          "ptxas": f"-O{level}", "registers":
                          int(regs[0]) if regs else None,
                          "sass_instructions": sum(ops.values()),
                          "result": "right" if ok else "WRONG", **res}),
              flush=True)
    # the 40 bytes no kernel reads: does their value, or the run, change
    # the wrong build's outputs?
    first = launch("tail_O3", args, FILLS[0])
    for i, fill in enumerate(FILLS[1:], 1):
        got = launch("tail_O3", args, fill)
        print(json.dumps({"build": "tail_O3", "run": i, "tail_fill": fill,
                          "outputs_equal_run_0": all(
                              torch.equal(g, f) for g, f in zip(got, first)),
                          **compare(got, want)}), flush=True)
    # which column maxima the wrong build wrote, and what the dumping
    # builds' device globals say against the plain twin
    plain = plain_run(args)
    print(json.dumps({"build": "tail_O3", "maxcol": maxcol_hypotheses(
        first, args, plain), "static_mask": static_mask_fit(
            first, args, plain)}), flush=True)
    np.savez(os.path.join(OUT, "tail_O3_outputs.npz"),
             **{n: x.cpu().numpy() for n, x in zip(NAMES, first)})
    # the one change of the plain twin that gives the wrong build's
    # outputs, and the SASS that makes E's decay: -gapE per half (the
    # packed VIADD.16x2 adds of E - gapE, the PRMTs of the kernel)
    print(json.dumps({"build": "tail_O3", "outputs_equal_faulted_twin":
                      fault_model(first, args)}), flush=True)
    for name in ("production_O3", "tail_O3", "tail_O1"):
        print(json.dumps({"build": name, "sass_viadd16x2_prmt": sass_lines(
            os.path.join(OUT, f"lib{name}.so"), r"^(VIADD\.16x2|PRMT)")}),
              flush=True)
    edits_of = {n: e for n, e, _ in BUILDS}
    for n in DUMPED:
        d = dump(n, args)
        res = compare(d["out"], want)
        wrong = any(res[k] for k in NAMES)
        print(json.dumps({"build": n, "result": "WRONG" if wrong else
                          "right", **res,
                          **dump_report(d, args, plain, edits_of[n]),
                          **({"static_mask": static_mask_fit(
                              d["out"], args, plain),
                              "outputs_equal_faulted_twin": fault_model(
                                  d["out"], args)} if wrong else {})}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
