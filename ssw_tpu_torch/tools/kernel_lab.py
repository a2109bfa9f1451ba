"""Variant lab of the int32 forward kernel: time the column chain with one
part removed or changed, to see where its cycles go.

The port of the JAX package's TPU lab tools/kernel_lab.py.  The kernel is
csrc/sw_lab.cu, a copy of the production column-scan base-mode body
(sw_forward.cu, quirk off: the body of every gated int32 launch, and of
an ungated one with scan_body=True) with one compile-time switch per
variant; the production kernels are untouched.  Variants and what each is
compared with:

  full        the production column-scan body: exactly
              cuda_sw.forward_shared(scan_body=True) (int32, quirk off)
              and the plain twin
  nostore     no per-32-column maxcol store: score and ends
  notrack     no column reduce, best-hit branch or save_best: the final
              H and E rows
  nodp        H += sub in place of the recurrence: its own plain twin
  noprofile   sub = profile row 0 held in registers: the plain twin on an
              all-zero target
  skeleton    the column loop, code shuffle and a store: timed only
  noclamp     max(h + sub, E) on h~ (E >= 0 makes the 0 redundant): full
  shortscan!m the warp scan cut to m of its 5 steps (inexact): the plain
              truncated model (scan_sw._truncated_prefix at depth m)
  radix4      the 5-step shuffle scan as 3 radix-4 steps: full
  lanetrack   per-lane trackers, no per-column reduce (the JAX `lanetrack`
              and `enc`): block maxima, score and ends of the production
              blockmax mode
  gatescan    the production gate path with the card's tiers (the JAX
              `gatescan`, `r3e2`): full, and its steps by depth against the
              plain model's

The JAX variants with no counterpart here:
  maskstore   a VMEM masked store (pltpu.store(mask=)); the card stores one
              int16 per lane per 32 columns already
  concat      a per-UNROLL VMEM tile of column maxima; same reason
  ring8       an 8-deep VMEM ring of H for a batched reduce; the card's
              reduce is one warp instruction per column
  packtrack   a packed (value, lane) key reduce; the card's best lane is
              found once, at the end (end_read_of)
  trim        a vreg dataflow rewrite around the TPU's biased domain
  biased      the same, the DP state kept biased by dmg
  selectchain a where-chain profile select instead of a dynamic VMEM index;
              the card indexes shared memory directly
  @unroll     the TPU's columns per fori_loop step; nvcc unrolls the lanes,
              and the column loop stays one loop

Grammar (the JAX lab's): `variant[#B | #BxL][!m][?]`; `#B` sets the batch
(L 256), `#BxL` both; the columns are (128 * 128 * 256) // (B * L) blocks
of 256 (default B 128, L 256, 32,768 columns), as in the JAX lab; `!m`
is shortscan's depth (default 2); `?` prints gatescan's column steps by
scan depth.  Inputs are the JAX lab's: profile (6, B, L) in [-2, 2] and
target codes in [0, 4) from one seeded generator, every lane valid, gapO 3,
gapE 1.

    python -m ssw_tpu_torch.tools.kernel_lab full nostore gatescan? ...
    python -m ssw_tpu_torch.tools.kernel_lab --device cpu full#8x64

On the card each label is timed in turns against `full` at its shape
(A B B A), with ms, the delta against full, registers (ptxas -v) and
`verify`'s exact check: the kernel-run comparisons on the whole input and
the plain twin on its first TWIN_COLS columns.  With --device cpu the
plain twin runs instead (correctness only).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ssw_tpu_torch.ops import _kernels, cuda_sw, gate as gate_mod, scan_sw
from ssw_tpu_torch.tools import _common

VARIANTS = ("full", "nostore", "notrack", "nodp", "noprofile", "skeleton",
            "noclamp", "radix4", "lanetrack", "gatescan", "shortscan")
LAB_K = (2, 4, 8, 16)     # K = L/32 of the kernel's instantiations
GAPO, GAPE = 3, 1
MAX_SUB = 2               # max |score| of the lab's profile
COL_BLOCK = 256
B, L, NBLOCKS = 128, 256, 128
REPS = 8
SHORT_DEFAULT = 2
BIG = 2 ** 30             # a depth threshold no column max reaches
TWIN_COLS = 1024          # main: the plain twin's columns per label
DEFAULT_LABELS = ("full", "full#64", "full#256", "full#512", "full#1024",
                  "full#256x512")
ALL_LABELS = ("full", "nostore", "notrack", "nodp", "noprofile",
              "skeleton", "noclamp", "radix4", "lanetrack", "gatescan?",
              "shortscan!0", "shortscan!1", "shortscan!2", "shortscan!3",
              "shortscan!4")


def parse(label: str) -> dict:
    """variant[#B | #BxL][!m][?] -> variant, depth m, count, B, L, blocks."""
    v, b, l, nb = label, B, L, NBLOCKS
    count = v.endswith("?")
    if count:
        v = v[:-1]
    m = None
    if "!" in v:
        v, s = v.split("!")
        m = int(s)
    if "#" in v:
        v, s = v.split("#")
        b, l = ((int(x) for x in s.split("x")) if "x" in s
                else (int(s), L))
        nb = max(1, (128 * 128 * 256) // (b * l))
    if v not in VARIANTS:
        raise ValueError(f"{label}: variant {v!r} is not one of {VARIANTS} "
                         f"(the module docstring lists the JAX variants "
                         f"with no counterpart)")
    if v == "shortscan":
        m = SHORT_DEFAULT if m is None else m
        if not 0 <= m < gate_mod.DEPTHS:
            raise ValueError(f"{label}: shortscan's depth is 0..4")
    elif m is not None:
        raise ValueError(f"{label}: !m is shortscan's depth")
    if count and v != "gatescan":
        raise ValueError(f"{label}: ? counts gatescan's steps")
    return {"variant": v, "m": m, "count": count, "B": b, "L": l,
            "blocks": nb}


def jax_inputs(rng, b=B, l=L, nblocks=NBLOCKS):
    """The JAX lab's inputs from generator rng: profile (6, b, l) int32 in
    [-2, 2], then ref_blocks (nblocks, 1, 256) int32 in [0, 4)."""
    profile = rng.integers(-2, 3, (6, b, l)).astype(np.int32)
    ref_blocks = rng.integers(0, 4, (nblocks, 1, COL_BLOCK)).astype(np.int32)
    return profile, ref_blocks


def from_jax(profile, ref_blocks, device="cpu"):
    """The JAX lab's numpy inputs as the port's forward-kernel arguments
    (prof, ref, read_len, col_mask, seg_id, seg_start): the (n1, B, L)
    profile becomes (B, n1, L) int8, the (NBLOCKS, 1, 256) blocks one (R,)
    target, and every lane is valid (read_len = L, col_mask all true; the
    lane-block geometry is the quirk's and goes unused)."""
    n1, b, l = profile.shape
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)
    return (t(profile.transpose(1, 0, 2).astype(np.int8)),
            t(ref_blocks.reshape(-1).astype(np.int32)),
            t(np.full(b, l, np.int32)), t(np.ones((b, l), bool)),
            t(np.zeros((b, l), np.int8)), t(np.zeros((b, l), bool)))


def variant_id(variant: str, m: int | None = None) -> int:
    if variant == "shortscan":
        return VARIANTS.index("shortscan") + m
    return VARIANTS.index(variant)


def card_gate(args, max_sub=MAX_SUB, gapO=GAPO, gapE=GAPE):
    """gatescan's thresholds: the card's tiers (ops/gate.py) at K = L/32."""
    l = int(args[0].shape[2])
    return gate_mod.card_thresholds(l // 32, l, gapO, gapE, max_sub)


def forced_depth(m: int):
    """Thresholds that put every column at scan depth m."""
    return (gate_mod.NEG,) * m + (BIG,) * (gate_mod.DEPTHS - m)


# ---- plain twins

def _nodp_ref(prof, ref, read_len, col_mask):
    """H += sub per column, the trackers of the base mode."""
    b, _, l = prof.shape
    prof_t = prof.to(torch.int32).permute(1, 0, 2)
    H = torch.zeros((b, l), dtype=torch.int32, device=prof.device)
    gmax = torch.zeros(b, dtype=torch.int32, device=prof.device)
    end_ref = torch.full_like(gmax, -1)
    h_best = torch.zeros_like(H)
    mc = torch.empty((ref.numel(), b), dtype=torch.int32, device=prof.device)
    for j, code in enumerate(ref.tolist()):
        H = H + prof_t[code]
        colmax = torch.where(col_mask, H, 0).amax(dim=1).clamp_min(0)
        upd = colmax > gmax
        gmax = torch.where(upd, colmax, gmax)
        end_ref = torch.where(upd, j, end_ref)
        h_best = torch.where(upd[:, None], H, h_best)
        mc[j] = colmax
    score, end_ref, end_read = scan_sw._finalize(
        (H, None, gmax, end_ref, h_best), read_len, l)
    return score, end_ref, end_read, \
        mc.clamp_max(32767).to(torch.int16).t().contiguous()


def _final_rows(prof, ref, seg_id, seg_start, col_mask, gapO, gapE):
    """The base mode's H and E after the last column, (B, 2, L)."""
    b, _, l = prof.shape
    dev = prof.device
    prof_t = prof.to(torch.int32).permute(1, 0, 2).contiguous()
    decay, seg_bias, seg_reset = scan_sw._geometry(seg_id, seg_start, l,
                                                   gapE, dev)
    state = scan_sw._init_state(b, l, dev)
    for j, code in enumerate(ref.tolist()):
        state, _ = scan_sw._column_update(
            prof_t[code], state, gapO, gapE, decay, seg_bias, seg_reset,
            col_mask.to(torch.bool), j, quirk=False)
    return torch.stack(state[:2], dim=1)


def plain(variant, args, gapO=GAPO, gapE=GAPE, m=None, gate=None) -> dict:
    """The plain PyTorch twin of `variant` on the forward-kernel arguments
    args: a dict of the outputs the variant defines."""
    prof, ref, rl, cm, seg, ss = args
    fs = lambda r, **kw: scan_sw.forward_shared_ref(
        prof, r, rl, cm, seg, ss, gapO, gapE, False, **kw)
    names = ("score", "end_ref", "end_read", "maxcol")
    if variant in ("full", "noclamp", "radix4"):
        return dict(zip(names, fs(ref)))
    if variant == "nostore":
        return dict(zip(names[:3], fs(ref)[:3]))
    if variant == "noprofile":
        return dict(zip(names, fs(torch.zeros_like(ref))))
    if variant == "shortscan":
        return dict(zip(names, fs(ref, gate=forced_depth(m))))
    if variant == "gatescan":
        out, hist = fs(ref, gate=gate, steps=True)
        return {**dict(zip(names, out)), "steps": hist}
    if variant == "lanetrack":
        return dict(zip(names[:3] + ("blockmax",), fs(ref, blockmax=True)))
    if variant == "notrack":
        return {"rows": _final_rows(prof, ref, seg, ss, cm, gapO, gapE)}
    if variant == "nodp":
        return dict(zip(names, _nodp_ref(prof, ref, rl, cm.to(torch.bool))))
    return {"maxcol": ref.to(torch.int16)[None, :].expand(
        prof.shape[0], -1).contiguous()}  # skeleton


# ---- the kernel

def _launch(variant, args, gapO, gapE, m, gate):
    prof, ref, rl, cm = args[:4]
    b, n1, l = prof.shape
    if l % 32 or l // 32 not in LAB_K:
        raise ValueError(f"L = {l}: the lab has K = L/32 in {LAB_K}")
    dev = prof.device
    for name, x, dt, shape in (("profile", prof, torch.int8, (b, n1, l)),
                               ("ref", ref, torch.int32, (ref.numel(),)),
                               ("read_len", rl, torch.int32, (b,)),
                               ("col_mask", cm, torch.bool, (b, l))):
        cuda_sw._check(name, x, dt, shape, dev)
    R = int(ref.numel())
    nblk = (R + COL_BLOCK - 1) // COL_BLOCK
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    out = {}
    if variant == "notrack":
        out["rows"] = i32(b, 2, l)
    elif variant == "skeleton":
        out["maxcol"] = torch.empty((b, R), dtype=torch.int16, device=dev)
    else:
        out.update(score=i32(b), end_ref=i32(b), end_read=i32(b))
        if variant == "lanetrack":
            out["blockmax"] = i32(b, nblk)
        elif variant != "nostore":
            out["maxcol"] = torch.empty((b, R), dtype=torch.int16,
                                        device=dev)
    thr = hist = None
    if variant == "gatescan":
        if gate is None:
            raise ValueError("gatescan needs its thresholds (card_gate)")
        thr = (ctypes.c_int * gate_mod.DEPTHS)(*gate)
        out["steps"] = torch.zeros(gate_mod.DEPTHS + 1, dtype=torch.int64,
                                   device=dev)
        hist = out["steps"].data_ptr()
    ptr = lambda k: out[k].data_ptr() if k in out else None
    lib = _kernels.load("sw_lab")
    with torch.cuda.device(dev):
        rc = lib.sw_lab_run(
            variant_id(variant, m), prof.data_ptr(), ref.data_ptr(),
            rl.data_ptr(), cm.data_ptr(), b, n1, l, R, int(gapO), int(gapE),
            ptr("score"), ptr("end_ref"), ptr("end_read"), ptr("maxcol"),
            ptr("blockmax"), ptr("rows"), thr, hist, _common.stream(dev))
    _common.raise_on(lib, rc, f"sw_lab {variant}")
    _common.LAUNCHES["sw_lab"] += 1
    return out


def run(variant, args, gapO=GAPO, gapE=GAPE, m=None, gate=None) -> dict:
    """Variant `variant` (shortscan at depth m, gatescan with thresholds
    gate) on the forward-kernel arguments args: the kernel for CUDA
    tensors, the plain twin for CPU ones.  Returns the outputs the variant
    defines (plain's keys)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    if variant == "shortscan" and m is None:
        m = SHORT_DEFAULT
    if args[0].device.type == "cpu":
        return plain(variant, args, gapO, gapE, m, gate)
    return _launch(variant, args, gapO, gapE, m, gate)


def _err(got: dict, want: dict) -> int:
    err = 0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            raise AssertionError(f"{k}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def reference(variant, args, gapO=GAPO, gapE=GAPE, m=None, gate=None,
              twin=True) -> dict | None:
    """What `variant` is compared with (the module docstring's table): its
    plain twin, or with twin=False only the comparisons a kernel run gives
    (full against the production column-scan body; noclamp, radix4 and
    gatescan's outputs against full; lanetrack against its blockmax mode),
    None when there is none."""
    on_card = args[0].device.type == "cuda"
    names = ("score", "end_ref", "end_read", "maxcol")
    if variant == "skeleton":
        return None
    if variant == "full" and on_card and not twin:
        return dict(zip(names, cuda_sw.forward_shared(
            *args, gapO, gapE, False, scan_body=True)))
    if variant == "lanetrack" and not twin:
        return dict(zip(names[:3] + ("blockmax",), cuda_sw.forward_shared(
            *args, gapO, gapE, False, blockmax=True, scan_body=True)))
    if variant in ("noclamp", "radix4", "gatescan") and not twin:
        return run("full", args, gapO, gapE)
    if not twin:
        return None
    want = plain(variant, args, gapO, gapE, m, gate)
    if variant == "gatescan" and on_card:
        want["steps"] = want["steps"].to(args[0].device)
    return want


def check(variant, args, gapO=GAPO, gapE=GAPE, m=None, gate=None,
          twin=True) -> int | None:
    """max_abs_err of the variant against reference(...) on the fields it
    defines (gatescan: and its depth histogram against the plain model's
    with twin), or None when it has no comparison."""
    want = reference(variant, args, gapO, gapE, m, gate, twin)
    if want is None:
        return None
    got = run(variant, args, gapO, gapE, m, gate)
    if variant == "gatescan" and not twin:
        got = {k: v for k, v in got.items() if k != "steps"}
    return _err(got, want)


def verify(variant, args, gapO=GAPO, gapE=GAPE, m=None, gate=None,
           twin_cols=None) -> int | None:
    """max_abs_err of the variant against every comparison it has: the
    kernel-run ones on args, and its plain twin on args' first twin_cols
    target columns (all of them by default).  None for skeleton, which has
    no comparison; raises when a variant with a twin was compared with
    nothing."""
    if variant == "skeleton":
        return None
    sl = args if twin_cols is None else (
        args[0], args[1][:twin_cols].contiguous(), *args[2:])
    errs = [e for e in (check(variant, args, gapO, gapE, m, gate, False),
                        check(variant, sl, gapO, gapE, m, gate, True))
            if e is not None]
    if not errs:
        raise AssertionError(f"{variant}: no comparison ran")
    return max(errs)


def registers(variant, m, K) -> int | None:
    """ptxas registers of the variant's kernel at K (None when the library
    was not built in this process)."""
    key = f"sw_lab_kernelILi{variant_id(variant, m)}ELi{K}E"
    return next((r for n, r in _common.registers("sw_lab").items()
                 if key in n), None)


def time_label(label: str, args, reps: int = REPS,
               twin_cols: int | None = None) -> dict:
    """One row of the lab's table: the label's variant timed in turns
    against `full` on args (A B B A), its verify(...) error (the plain twin
    on the first twin_cols columns), registers, and gatescan's steps."""
    p = parse(label)
    v, m = p["variant"], p["m"]
    gate = card_gate(args) if v == "gatescan" else None
    full = lambda: run("full", args)
    var = lambda: run(v, args, m=m, gate=gate)
    if v == "full":
        ms = full_ms = _common.time_ms(full, reps)
    else:
        full_ms, ms = _common.in_turns(full, var, reps)
    b, n1, l = args[0].shape
    R = int(args[1].numel())
    row = {"label": label, "ms": ms, "full_ms": full_ms,
           "delta_pct": (ms / full_ms - 1) * 100,
           "g_lane_cells_per_s": b * l * R / ms / 1e6,
           "registers": registers(v, m, l // 32),
           "max_abs_err": verify(v, args, m=m, gate=gate,
                                 twin_cols=twin_cols),
           "shape": f"B={b} L={l} R={R}"}
    if p["count"]:
        row["steps_by_depth"] = run(v, args, m=m, gate=gate)["steps"].tolist()
    return row


def format_row(r: dict) -> str:
    err = r["max_abs_err"]
    s = (f"{r['label']:14s} {r['shape']:22s} {r['ms']:9.3f} ms  "
         f"{r['delta_pct']:+7.2f} % vs full  {r['g_lane_cells_per_s']:7.1f} "
         f"G lane-cells/s  regs {r['registers']}  "
         f"max_abs_err {'-' if err is None else err}")
    if "steps_by_depth" in r:
        s += f"  steps by depth {r['steps_by_depth']}"
    return s


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = _common.resolve_device(_common.device_of(argv) or device)
    labels = argv or list(DEFAULT_LABELS)
    rng = np.random.default_rng(0)
    if dev.type != "cpu":
        print(f"card: {torch.cuda.get_device_name(dev)}; nvidia-smi: "
              f"{_common.card_line()}", flush=True)
    bad = []
    for label in labels:
        p = parse(label)
        args = from_jax(*jax_inputs(rng, p["B"], p["L"], p["blocks"]), dev)
        if dev.type == "cpu":
            gate = card_gate(args) if p["variant"] == "gatescan" else None
            out = run(p["variant"], args, m=p["m"], gate=gate)
            summary = ", ".join(f"{k} {tuple(v.shape)} sum "
                                f"{int(v.long().sum())}"
                                for k, v in out.items())
            print(f"{label:14s}: {summary} (CPU: correctness only)",
                  flush=True)
            continue
        r = time_label(label, args, twin_cols=TWIN_COLS)
        print(format_row(r), flush=True)
        if r["max_abs_err"]:
            bad.append(label)
    if bad:
        raise AssertionError(f"variants differ from their comparison: "
                             f"{bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
