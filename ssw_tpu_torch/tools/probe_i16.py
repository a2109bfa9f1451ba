"""int16 and DPX op probes on the card: the value of each formulation and
the SASS instructions it compiles to.

The port of the JAX package's TPU probe tools/probe_i16.py, whose nine
@probe formulations (maxi ... i32_cmp_max) ask whether Mosaic compiles
them on an (8, 128) int16 array.  Here each one computes its JAX formula
on the card (csrc/probe_i16.cu) and is held exactly against its plain
PyTorch twin (the registry function of the same name), on the JAX tool's
inputs (`ones * (i + 1)`) and on random halves in the int16 tier's domain
[-2^14, 2^14).  Six DPX probes add the intrinsics the forward kernels use,
each checked against its twin the same way.  `edge_table` records whether
each add of those intrinsics wraps or saturates at the int16 / int32
bounds (a record, not a check), and `sass_report` lists each probe's
instructions from `cuobjdump -sass` (one DPX / VIMNMX instruction, or an
emulated sequence).

    python -m ssw_tpu_torch.tools.probe_i16 [name ...]             # card
    python -m ssw_tpu_torch.tools.probe_i16 --device cpu [name ...]  # twins
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ssw_tpu_torch.ops import _kernels
from ssw_tpu_torch.tools import _common

SHAPE = (8, 128)       # the JAX tool's (8, 128) arrays
DOMAIN = 2 ** 14       # the int16 tier's halves: [-2^14, 2^14)
DOMAIN32 = 2 ** 28     # s32 probes' inputs: sums stay inside int32
NEG16 = -16384

PROBES = {}   # name -> (twin, number of inputs, dtype)
KERNEL_ID = {}  # name -> probe index of csrc/probe_i16.cu


def probe(name, n_in=1, dtype=torch.int16):
    def deco(fn):
        KERNEL_ID[name] = len(PROBES)
        PROBES[name] = (fn, n_in, dtype)
        return fn
    return deco


def _shift_right(x, s, fill):
    col = torch.full((x.shape[0], s), fill, dtype=x.dtype, device=x.device)
    return torch.cat([col, x[:, :-s]], dim=1)


# ---- the nine formulations of the JAX tool, its order and names

@probe("maxi")
def _maxi(x):
    return torch.maximum(x, torch.tensor(3, dtype=torch.int16))


@probe("subi")
def _subi(x):
    return x - 1


@probe("addi")
def _addi(x):
    return x + (-1)


@probe("where_max", 2)
def _where_max(a, b):
    return torch.where(a > b, a, b)


@probe("select_ge", 2)
def _select_ge(a, b):
    return torch.where(a >= b, a, b)


@probe("pad_slice")
def _pad_slice(x):
    return _shift_right(x, 1, -3)


@probe("full_step", 3)
def _full_step(sub, H, E):
    """A faithful miniature of the real DP column step in int16."""
    hd = _shift_right(H, 1, 0)
    ht = torch.maximum(torch.maximum(hd + sub, E),
                       torch.tensor(0, dtype=torch.int16))
    c = ht + (-3)
    s = 1
    while s < c.shape[1]:
        c = torch.maximum(c, _shift_right(c, s, NEG16))
        s *= 2
    F = _shift_right(c, 1, NEG16)
    H2 = torch.maximum(ht, F + 1)
    E2 = torch.maximum(torch.maximum(E - 1, H2 - 3),
                       torch.tensor(0, dtype=torch.int16))
    return H2 + E2


@probe("mixed_cast")
def _mixed_cast(x):
    """int16 state, int32 colmax reduction (what the kernel's tracker
    does)."""
    m = x.to(torch.int32).amax(dim=1, keepdim=True)
    return x + m.to(torch.int16)


@probe("i32_cmp_max", 2)
def _i32_cmp_max(a, b):
    m = a.to(torch.int32) > b.to(torch.int32)
    return torch.where(m, a, b)


# ---- the DPX intrinsics of the forward kernels, per 16-bit half or s32;
# inside DOMAIN / DOMAIN32 no add leaves its type

def _wrap16(x):
    return x.to(torch.int16)


@probe("viaddmax_s16x2", 3)
def _viaddmax_s16x2(a, b, c):
    return _wrap16(torch.maximum(a.int() + b.int(), c.int()))


@probe("viaddmax_s16x2_relu", 3)
def _viaddmax_s16x2_relu(a, b, c):
    return _wrap16(torch.maximum(a.int() + b.int(), c.int()).clamp_min(0))


@probe("vmaxs2", 2)
def _vmaxs2(a, b):
    return torch.maximum(a, b)


@probe("vsub2", 2)
def _vsub2(a, b):
    return _wrap16(a.int() - b.int())


@probe("viaddmax_s32", 3, torch.int32)
def _viaddmax_s32(a, b, c):
    return torch.maximum(a.long() + b.long(), c.long()).int()


@probe("viaddmax_s32_relu", 3, torch.int32)
def _viaddmax_s32_relu(a, b, c):
    return torch.maximum(a.long() + b.long(), c.long()).clamp_min(0).int()


REGISTRY = tuple(list(PROBES)[:9])   # the JAX tool's names
DPX = tuple(list(PROBES)[9:])


def registry_inputs(name, device="cpu"):
    """The JAX tool's _run inputs: ones((8, 128)) * (i + 1) per input."""
    _, n_in, dt = PROBES[name]
    return [torch.ones(SHAPE, dtype=dt, device=device) * (i + 1)
            for i in range(n_in)]


def random_inputs(name, seed, device="cpu"):
    """Seeded inputs in the tier's domain: halves in [-2^14, 2^14) (s32
    probes: [-2^28, 2^28))."""
    _, n_in, dt = PROBES[name]
    rng = np.random.default_rng(seed)
    lim = DOMAIN32 if dt == torch.int32 else DOMAIN
    npdt = np.int32 if dt == torch.int32 else np.int16
    return [torch.as_tensor(rng.integers(-lim, lim, SHAPE).astype(npdt))
            .to(device) for _ in range(n_in)]


def run(name, xs):
    """Probe `name` on its inputs xs: the kernel for CUDA tensors, the
    plain twin for CPU ones."""
    fn, n_in, dt = PROBES[name]
    if len(xs) != n_in or any(x.dtype != dt or x.shape != xs[0].shape
                              for x in xs):
        raise ValueError(f"{name}: {n_in} {dt} tensors of one shape")
    if xs[0].device.type == "cpu":
        return fn(*xs)
    xs = [x.contiguous() for x in xs]
    rows, cols = xs[0].shape
    out = torch.empty_like(xs[0])
    ptr = [x.data_ptr() for x in xs] + [None] * (3 - n_in)
    lib = _kernels.load("probe_i16")
    dev = xs[0].device
    with torch.cuda.device(dev):
        rc = lib.probe_i16_run(KERNEL_ID[name], *ptr, out.data_ptr(), rows,
                               cols, _common.stream(dev))
    _common.raise_on(lib, rc, f"probe_i16 {name}")
    _common.LAUNCHES["probe_i16"] += 1
    return out


def check(name, device, seeds=(0, 1)) -> int:
    """max_abs_err of the probe on the card (or the twin on the CPU)
    against the twin, on the JAX inputs and on random domain inputs."""
    err = 0
    sets = [registry_inputs(name)] + [random_inputs(name, s) for s in seeds]
    for xs in sets:
        got = run(name, [x.to(device) for x in xs]).cpu()
        want = PROBES[name][0](*xs)
        err = max(err, int((got.long() - want.long()).abs().max()))
    return err


# ---- edge inputs: does each add wrap or saturate?

EDGES16 = ((32767, 1, -32768), (-32768, -1, -32768), (32767, 32767, 0),
           (-32768, -32768, -32768))
EDGES_SUB16 = ((-32768, 1, 0), (32767, -1, 0), (-32768, 32767, 0),
               (0, -32768, 0))
EDGES32 = ((2 ** 31 - 1, 1, -2 ** 31), (-2 ** 31, -1, -2 ** 31))


def _expect(name, a, b, c, mode, bits):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    s = a - b if name == "vsub2" else a + b
    if mode == "wraps":
        s = (s - lo) % (1 << bits) + lo
    else:
        s = min(max(s, lo), hi)
    if name == "vsub2":
        return s
    r = max(s, c)
    return max(r, 0) if name.endswith("relu") else r


def edge_table(device) -> list[dict]:
    """Each add/sub DPX probe at the int16 or int32 bounds: the result, and
    whether it matches a wrapping or a saturating add.  On the 16-bit forms
    each edge case sits in the low half with zeros in the high half, and
    the high half is checked for a carry out of the low one."""
    rows = []
    for name in ("viaddmax_s16x2", "viaddmax_s16x2_relu", "vsub2",
                 "viaddmax_s32", "viaddmax_s32_relu"):
        _, n_in, dt = PROBES[name]
        bits = 32 if dt == torch.int32 else 16
        edges = (EDGES32 if bits == 32 else
                 EDGES_SUB16 if name == "vsub2" else EDGES16)
        for a, b, c in edges:
            vals = (a, b, c)[:n_in]
            xs = [torch.zeros((1, 2), dtype=dt) for _ in range(n_in)]
            for x, v in zip(xs, vals):
                x[0, 0] = v
            got = run(name, [x.to(device) for x in xs]).cpu()
            r = int(got[0, 0])
            how = [m for m in ("wraps", "saturates")
                   if r == _expect(name, a, b, c, m, bits)]
            rows.append({"probe": name, "inputs": list(vals), "result": r,
                         "add": " and ".join(how) or "neither",
                         "high_half": int(got[0, 1])})
    return rows


# ---- SASS: the instructions each probe compiles to

# instructions every elementwise probe has around its formula: thread
# index, bounds check, address arithmetic, loads, stores, control
_PLUMBING = ("S2R", "S2UR", "LDC", "ULDC", "ISETP", "EXIT", "BRA", "NOP",
             "IMAD", "LDG", "STG", "MOV", "LEA", "CS2R")


def _kernel_name(name, funcs):
    i = KERNEL_ID[name]
    if name == "full_step":
        key = "full_step_kernel"
    elif name in ("pad_slice", "mixed_cast"):
        key = f"row_kernelILi{i}E"
    elif name in ("i32_cmp_max", "viaddmax_s32", "viaddmax_s32_relu"):
        key = f"scalar_kernelILi{i}E"
    else:
        key = f"packed_kernelILi{i}E"
    return next(n for n in funcs if key in n)


def sass_report() -> dict:
    """Per probe: the instructions of its kernel outside the plumbing every
    probe shares (IMAD, LEA and MOV count as plumbing: index and address
    arithmetic), and the verdict: one instruction, or a sequence."""
    funcs = _common.sass("probe_i16")
    out = {}
    for name in PROBES:
        ops = [op for _, op, _ in funcs[_kernel_name(name, funcs)]
               if op.split(".")[0] not in _PLUMBING]
        out[name] = {"instructions": ops,
                     "verdict": ("one instruction" if len(ops) == 1 else
                                 f"a sequence of {len(ops)}")}
    return out


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = _common.resolve_device(_common.device_of(argv) or device)
    names = [a for a in argv if not a.startswith("-")] or list(PROBES)
    bad = []
    for name in names:
        err = check(name, dev)
        print(f"{'OK' if err == 0 else 'FAIL'} {name}: max_abs_err {err}",
              flush=True)
        if err:
            bad.append(name)
    if dev.type != "cpu":
        print(f"card: {torch.cuda.get_device_name(dev)}; nvidia-smi: "
              f"{_common.card_line()}")
        for row in edge_table(dev):
            print(f"edge {row['probe']:20s} {row['inputs']} -> "
                  f"{row['result']} (add {row['add']}; high half "
                  f"{row['high_half']})")
        for name, rep in sass_report().items():
            if name in names:
                print(f"sass {name:20s}: {rep['verdict']}: "
                      f"{' '.join(rep['instructions'])}")
    if bad:
        raise AssertionError(f"probes differ from their twins: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
