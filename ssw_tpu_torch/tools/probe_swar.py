"""Dependent max chains on the card: native int32, the guard-bit packed
2 x int16 (SWAR) max, and the hardware s16x2 forms the int16 tier uses.

The port of the JAX package's TPU probe tools/probe_swar.py (its
_native_kernel and _swar_kernel, a DEPTH = 256 chain over a (64, 512)
int32 array).  The kernel is csrc/probe_swar.cu, one templated chain per
form (FORMS); each form's plain PyTorch twin is `chain_ref`.  The SWAR max
(packed_max) emulates a per-half max with 8 ops on halves in [0, 2^15);
Hopper has it as one instruction (__vmaxs2, the `vmaxs2` form), and the
DPX add-max forms (`viaddmax_s16x2`, `viaddmax_s32`) are the forward
kernels' fused step.

    python -m ssw_tpu_torch.tools.probe_swar               # on the card
    python -m ssw_tpu_torch.tools.probe_swar --device cpu  # twin, exactness

On the card it checks packed_max exactly, holds every form's chain at the
JAX shape against the twin (and vmaxs2 against swar bit for bit), counts
the max instructions of each form's loop body in `cuobjdump -sass` (8 chain
steps per body; fewer maxes than steps means nvcc folded the chain), and
times ns per step with one warp and a long chain (latency) and on the whole
card (throughput).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ssw_tpu_torch.ops import _kernels
from ssw_tpu_torch.tools import _common

G = np.int32(np.uint32(0x8000_8000))   # two's-complement int32 literal
LOW = np.int32(0x7FFF_7FFF)
DEPTH = 256            # dependent-op chain length of the JAX shape
B, L = 64, 512         # the JAX tool's shape
UNROLL = 8             # chain steps per loop body (csrc/probe_swar.cu)
FORMS = ("native", "swar", "vmaxs2", "viaddmax_s16x2", "viaddmax_s32")
PACKED = ("swar", "vmaxs2", "viaddmax_s16x2")  # two 16-bit halves per word
LAT_DEPTH = 1 << 16    # one warp's chain for the latency
CARD_N = 1 << 20       # elements of the whole-card throughput run
CARD_DEPTH = 4096


def increment(which: str) -> int:
    """y's step: +1 per element (+1 to each half when packed)."""
    return 0x0001_0001 if which in PACKED else 1


def packed_max(a, b):
    """Per-16-bit-half max of two packed pairs (halves in [0, 2**15)),
    int32 tensors."""
    g, low = int(G), int(LOW)
    t = (a | g) - b
    m = t & g
    mask = m - ((m >> 15) & 0x0001_0001)  # logical shift: guard bit 31
    return (a & mask) | (b & (mask ^ low))


def _halves(x):
    return x.contiguous().view(torch.int16)


def _step(which, x, y):
    if which == "native":
        return torch.maximum(x, y)
    if which == "swar":
        return packed_max(x, y)
    if which == "vmaxs2":
        return torch.maximum(_halves(x), _halves(y)).view(torch.int32)
    if which == "viaddmax_s16x2":  # z = 0: max(x + 0, y) per half
        return torch.maximum(_halves(x), _halves(y)).view(torch.int32)
    return torch.maximum(x, y)     # viaddmax_s32 with z = 0


def chain_ref(x, y, which: str, depth: int = DEPTH):
    """The plain twin: depth steps of x = step(x, y); y += increment."""
    inc = increment(which)
    for _ in range(depth):
        x = _step(which, x, y)
        y = y + inc
    return x


def _launch(x, y, which, depth, threads=256):
    lib = _kernels.load("probe_swar")
    out = torch.empty_like(x)
    dev = x.device
    with torch.cuda.device(dev):
        rc = lib.probe_swar_chain(FORMS.index(which), x.data_ptr(),
                                  y.data_ptr(), out.data_ptr(), x.numel(),
                                  depth, increment(which), 0, threads,
                                  _common.stream(dev))
    _common.raise_on(lib, rc, f"probe_swar {which}")
    _common.LAUNCHES["probe_swar"] += 1
    return out


def run(x, y, which: str, depth: int = DEPTH, threads: int = 256):
    """The chain of `which` over int32 tensors x, y of one shape: the
    kernel for CUDA tensors, the plain twin for CPU ones."""
    if which not in FORMS:
        raise ValueError(f"form {which!r} is not one of {FORMS}")
    if x.dtype != torch.int32 or y.dtype != torch.int32 or \
            x.shape != y.shape:
        raise ValueError("x, y: int32 tensors of one shape")
    if x.device.type == "cpu":
        return chain_ref(x, y, which, depth)
    if depth != 1 and depth % UNROLL:
        raise ValueError(f"depth {depth}: 1 or a multiple of {UNROLL}")
    return _launch(x.contiguous(), y.contiguous(), which, depth, threads)


def inputs(seed: int = 3, shape=(B, L)):
    """The JAX tool's bench inputs: 14-bit int32 x, y from seed 3."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 14, shape).astype(np.int32)
    y = rng.integers(0, 2 ** 14, shape).astype(np.int32)
    return x, y


def check_exact(rng, device="cpu"):
    """Packed max == per-half max on random 14-bit halves (the kernel's
    one-step swar and vmaxs2 chains on the card)."""
    a = rng.integers(0, 2 ** 14, (B, L), np.int64)
    b = rng.integers(0, 2 ** 14, (B, L), np.int64)
    c = rng.integers(0, 2 ** 14, (B, L), np.int64)
    d = rng.integers(0, 2 ** 14, (B, L), np.int64)
    pa = torch.as_tensor(((a << 16) | b).astype(np.int32)).to(device)
    pb = torch.as_tensor(((c << 16) | d).astype(np.int32)).to(device)
    want = (np.maximum(a, c) << 16) | np.maximum(b, d)
    for got in ([packed_max(pa, pb)] if torch.device(device).type == "cpu"
                else [run(pa, pb, "swar", 1), run(pa, pb, "vmaxs2", 1)]):
        got = got.cpu().numpy().astype(np.int64) & 0xFFFF_FFFF
        if not np.array_equal(got, want):
            raise AssertionError("packed max mismatch")


def exactness(device) -> dict:
    """max_abs_err of every form's DEPTH chain at the JAX shape on bench's
    inputs against the plain twin, and vmaxs2 against swar."""
    x, y = inputs()
    xt, yt = torch.as_tensor(x).to(device), torch.as_tensor(y).to(device)
    xc, yc = torch.as_tensor(x), torch.as_tensor(y)
    out, errs = {}, {}
    for which in FORMS:
        out[which] = run(xt, yt, which).cpu()
        want = chain_ref(xc, yc, which)
        errs[which] = int((out[which].long() - want.long()).abs().max())
    errs["vmaxs2_vs_swar"] = int(
        (out["vmaxs2"].long() - out["swar"].long()).abs().max())
    return errs


def sass_report() -> dict:
    """Per form: the instructions of its chain loop body and how many of
    them are max instructions (UNROLL steps per body)."""
    funcs = _common.sass("probe_swar")
    out = {}
    for f, which in enumerate(FORMS):
        name = next(n for n in funcs if f"chain_kernelILi{f}E" in n)
        body = _common.loop_body(funcs[name])
        ops = [op for _, op, _ in body]
        out[which] = {"loop_instructions": len(ops),
                      "max_instructions": sum(map(_common.is_max, ops)),
                      "steps": UNROLL, "opcodes": sorted(set(ops))}
    return out


def bench(which: str, device) -> dict:
    """ns per chain step: one warp, LAT_DEPTH steps (latency); the whole
    card, CARD_N elements x CARD_DEPTH steps (throughput, max per s counted
    per element: two per packed word); and ms of the JAX shape's call."""
    dev = torch.device(device)
    rng = np.random.default_rng(5)
    mk = lambda n: torch.as_tensor(
        rng.integers(0, 2 ** 14, n).astype(np.int32)).to(dev)
    x, y = mk(32), mk(32)
    lat_ms = _common.time_ms(lambda: run(x, y, which, LAT_DEPTH, 32), 3)
    x, y = mk(CARD_N), mk(CARD_N)
    card_ms = _common.time_ms(lambda: run(x, y, which, CARD_DEPTH), 3)
    xs, ys = inputs()
    xj, yj = torch.as_tensor(xs).to(dev), torch.as_tensor(ys).to(dev)
    jax_ms = _common.time_ms(lambda: run(xj, yj, which), 20)
    per = 2 if which in PACKED else 1
    return {"ns_per_step_warp": lat_ms * 1e6 / LAT_DEPTH,
            "ns_per_step_card": card_ms * 1e6 / CARD_DEPTH,
            "gmax_per_s_card": per * CARD_N * CARD_DEPTH / card_ms / 1e6,
            "ms_jax_shape": jax_ms}


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = _common.resolve_device(_common.device_of(argv) or device)
    check_exact(np.random.default_rng(0), dev)
    print("packed_max exact on 32k random pairs: OK", flush=True)
    errs = exactness(dev)
    print(f"chains at ({B}, {L}) x {DEPTH} vs the plain twin: "
          f"max_abs_err {errs}", flush=True)
    if any(errs.values()):
        raise AssertionError(f"chain mismatch: {errs}")
    if dev.type == "cpu":
        print("CPU: correctness only (timings not measured)")
        return 0
    print(f"card: {torch.cuda.get_device_name(dev)}; nvidia-smi: "
          f"{_common.card_line()}")
    sass = sass_report()
    for which, rep in sass.items():
        print(f"sass {which:15s}: {rep['max_instructions']} max of "
              f"{rep['loop_instructions']} instructions per "
              f"{rep['steps']} steps; {' '.join(rep['opcodes'])}")
    for which in FORMS:
        r = bench(which, dev)
        n_max = sass[which]["max_instructions"]
        per_insn = (f", {r['ns_per_step_warp'] * UNROLL / n_max:.3f} ns per "
                    f"dependent max instruction" if n_max else "")
        print(f"{which:15s}: {r['ns_per_step_warp']:.3f} ns/step one warp"
              f"{per_insn}, {r['ns_per_step_card']:.3f} ns/step card "
              f"({r['gmax_per_s_card']:.1f} Gmax/s), JAX shape "
              f"{r['ms_jax_shape'] * 1e3:.2f} us/call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
