"""What the three tools share: the device rule, their launch counts, CUDA
event timing and the reading of ptxas logs and `cuobjdump -sass`."""

from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import torch

from ssw_tpu_torch.ops import _kernels, common

# kernel launches per tool kernel, counted right after each successful
# launch (apart from ops/cuda_sw.LAUNCHES, the main path's)
LAUNCHES = {"probe_swar": 0, "probe_i16": 0, "sw_lab": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for the CPU; raises without one."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the tool needs a CUDA card "
                           "(torch.cuda.is_available() is False); pass "
                           "device='cpu' (--device cpu) for the plain twin")
    return torch.device(device if device is not None else "cuda")


def device_of(argv) -> str | None:
    """--device X from a tool's argv (removed in place), else None."""
    if "--device" in argv:
        i = argv.index("--device")
        dev = argv[i + 1]
        del argv[i:i + 2]
        return dev
    return None


def raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.sw_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card, or ''."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else ""


INT32_LANES_PER_SM = 64  # INT32 lanes per SM per clock (Hopper white paper)


def int32_rate(dev, mhz: float | None = None) -> float:
    """The card's peak INT32 rate, op/s: INT32 lanes x SMs x the max SM
    clock in MHz (given, else nvidia-smi's, else the H100's 1980)."""
    if mhz is None:
        try:
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, timeout=60)
            mhz = float(r.stdout.split()[0])
        except (OSError, ValueError, IndexError,
                subprocess.TimeoutExpired):
            mhz = 1980.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return INT32_LANES_PER_SM * sms * float(mhz) * 1e6


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean ms per call of fn over reps calls, by CUDA events."""
    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(fa, fb, reps: int) -> tuple[float, float]:
    """Mean ms of fa and fb timed in turns a, b, b, a after a warm-up."""
    fa()
    fb()
    ta = [time_ms(fa, reps, warm=False)]
    tb = [time_ms(fb, reps, warm=False) for _ in range(2)]
    ta.append(time_ms(fa, reps, warm=False))
    return sum(ta) / 2, sum(tb) / 2


def registers(name: str) -> dict:
    """{mangled kernel: registers} from the ptxas -v log of kernel library
    `name` (its last build in this process)."""
    out, cur = {}, None
    for line in _kernels.build_log.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = int(m.group(1))
            cur = None
    return out


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass(name: str) -> dict:
    """{mangled kernel: [(address, opcode, operands)]} of kernel library
    `name`, from `cuobjdump -sass` of its build."""
    cuobj = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    txt = subprocess.run([cuobj, "-sass", _kernels._lib_path(name)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3),
                        m.group(4).strip()))
    return funcs


def loop_body(insns) -> list:
    """The instructions of the innermost backward-branch loop: from the
    branch target to the branch (the shortest such span)."""
    best = None
    for i, (addr, op, args) in enumerate(insns):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m:
            continue
        tgt = int(m.group(1), 16)
        if tgt < addr:
            body = [x for x in insns[:i + 1] if x[0] >= tgt]
            if best is None or len(body) < len(best):
                best = body
    return best or []


def is_max(op: str) -> bool:
    """A min/max SASS instruction (IMNMX, VIMNMX, VIMNMX3, VIADDMNMX...)."""
    return "MNMX" in op.split(".")[0]


def shared_case(dev, *, B, L, R, mat, word, seed):
    """Random reads from seed (every odd one embedded in the target with 5 %
    of its codes redrawn) and their geometry: (forward-kernel arguments
    (prof, ref, read_len, col_mask, seg_id, seg_start), reads, target).
    chip_smoke.py's phase-3 inputs and i16_fault's failing input."""
    rng = np.random.default_rng(seed)
    n = mat.shape[0]
    ref = rng.integers(0, n - 1, R).astype(np.int32)
    lo = max(L // 3, 2)
    read_len = rng.integers(lo, max(lo + 1, L - 16), B).astype(np.int32)
    reads = []
    for b, ln in enumerate(read_len):
        if b % 2 and R > ln:
            s = int(rng.integers(0, R - ln))
            r = ref[s:s + ln].copy()
            m = rng.random(ln) < 0.05
            r[m] = rng.integers(0, n - 1, int(m.sum()))
        else:
            r = rng.integers(0, n - 1, ln).astype(np.int32)
        reads.append(r)
    rp = common.pad_reads(reads, L, n)
    prof = common.build_profile(rp, read_len, common.extend_matrix(mat))
    geo = common.batch_geometry(read_len, L, word=word)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return (t(prof), t(ref), t(read_len), t(geo.col_mask), t(geo.seg_id),
            t(geo.seg_start)), reads, ref


def terminate_case(dev, *, mat, word, seed, gapO=3, gapE=1, quirk=True,
                   L=64):
    """The per-read kernel's terminate rule by hand: one read, the segment
    seg + seg + 10 random codes (two rows tie at the column ending the
    repeat), against a window that holds seg, then seg + seg, then the
    whole read, with random codes between.  Its column maxima climb along
    each exact diagonal, so the column after almost every column holds a
    higher maximum, and values repeat across the three copies.  The read
    is repeated once per terminate value: -1, every distinct column
    maximum of the window (from the plain version at gapO, gapE, quirk)
    and one above them all.
    Returns (forward_perread's six tensors, terminate (B,) int32)."""
    from ssw_tpu_torch.ops import scan_sw

    rng = np.random.default_rng(seed)
    n = mat.shape[0] - 1
    rnd = lambda k: rng.integers(0, n, k).astype(np.int32)
    seg = rnd(12)
    read = np.concatenate([seg, seg, rnd(10)])
    window = np.concatenate([rnd(9), seg, rnd(7), seg, seg, rnd(5), read,
                             rnd(11)])
    rl = np.array([len(read)], np.int32)
    prof = common.build_profile(common.pad_reads([read], L, n), rl,
                                common.extend_matrix(mat))
    geo = common.batch_geometry(rl, L, word=word)
    one = tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in (
        prof, window[None], rl, geo.col_mask, geo.seg_id, geo.seg_start))
    mc = scan_sw.forward_perread_ref(*one, gapO, gapE, quirk,
                                     emit_maxcol=True)[3]
    vals = sorted(set(mc[0].tolist()))
    terms = np.array([-1] + vals + [vals[-1] + 1], np.int32)
    B = len(terms)
    args = tuple(x.expand(B, *x.shape[1:]).contiguous().to(dev)
                 for x in one)
    return args, torch.as_tensor(terms).to(dev)
