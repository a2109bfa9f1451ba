"""Build and load the hand-written CUDA kernels in ssw_tpu_torch/csrc/.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (`build/lib<name>.so`), loaded with ctypes: pointers pass
as c_void_p, the stream as PyTorch's current raw stream.  Builds happen at
first use, all sources of a group at once (one nvcc process each), and are
reused while no source is newer than its library.  Two groups: KERNELS,
the main path's, and TOOL_KERNELS, the measurement tools' of
ssw_tpu_torch/tools (built at a tool's first use; loading a main-path
kernel never waits on them).  A failed build raises with the
compiler's stderr; there is no fallback.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
KERNELS = ("sw_forward", "sw_forward_i16", "sw_forward_packed",
           "sw_perread", "sw_wave_i16", "sw_wave_packed", "sw_wave_i32",
           "sw_wave_perread")
TOOL_KERNELS = ("probe_swar", "probe_i16", "sw_lab")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # name -> nvcc stderr (-Xptxas -v register/spill lines)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sw_forward": {
        "sw_forward_shared": [_P] * 6 + [_I] * 7 + [_P] * 5 + [_I]
                             + [_P] * 5,
        "sw_forward_shared_owned": [_P] * 6 + [_I] * 7 + [_P] * 10,
        "sw_forward_scratch_per_read": [_I],
    },
    "sw_forward_i16": {
        "sw_forward_shared_i16": [_P] * 4 + [_I] * 6 + [_P] * 5 + [_I]
                                 + [_P] * 5,
        "sw_forward_shared_i16_owned": [_P] * 4 + [_I] * 6 + [_P] * 10,
        "sw_forward_i16_scratch_per_pair": [_I],
    },
    "sw_forward_packed": {
        "sw_forward_packed": [_P] * 6 + [_I] * 12 + [_P] * 8,
        "sw_forward_packed_scratch_per_read": [_I] * 2,
    },
    "sw_wave_i16": {
        "sw_wave_shared_i16": [_P] * 4 + [_I] * 6 + [_P] * 5 + [_I]
                              + [_P] * 3,
        "sw_wave_shared_i16_owned": [_P] * 4 + [_I] * 6 + [_P] * 8,
        "sw_wave_i16_scratch_per_pair": [_I],
    },
    "sw_wave_packed": {
        "sw_wave_packed": [_P] * 6 + [_I] * 12 + [_P] * 5 + [_I] * 3
                          + [_P] * 2,
        "sw_wave_packed_scratch_per_read": [_I] * 2,
        "sw_wave_packed_shape": [_I] * 4 + [_P],
    },
    "sw_wave_i32": {
        "sw_wave_shared_i32": [_P] * 6 + [_I] * 7 + [_P] * 5 + [_I]
                              + [_P] * 3,
        "sw_wave_shared_i32_owned": [_P] * 6 + [_I] * 7 + [_P] * 8,
        "sw_wave_i32_scratch_per_read": [_I],
    },
    "sw_wave_perread": {
        "sw_wave_perread": [_P] * 7 + [_I] * 7 + [_P] * 6,
        "sw_wave_perread_scratch_per_read": [_I],
    },
    "sw_perread": {
        "sw_forward_perread": [_P] * 7 + [_I] * 7 + [_P] * 6,
        "sw_perread_scratch_per_read": [_I],
    },
    "probe_swar": {
        "probe_swar_chain": [_I] + [_P] * 3 + [_I] * 5 + [_P],
    },
    "probe_i16": {
        "probe_i16_run": [_I] + [_P] * 4 + [_I] * 2 + [_P],
    },
    "sw_lab": {
        "sw_lab_run": [_I] + [_P] * 4 + [_I] * 6 + [_P] * 9,
    },
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of ssw_tpu_torch build from source at first use")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + glob.glob(
        os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(out) < max(os.path.getmtime(d) for d in deps)


def build(names=KERNELS) -> dict:
    """Compile every stale kernel library, one nvcc per source, all started
    together; returns {name: seconds-or-0}.  Raises on any failure."""
    import time

    todo = [n for n in names if _stale(n)]
    if not todo:
        return {n: 0.0 for n in names}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _lib_path(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    errors, secs = [], {}
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        secs[n] = time.perf_counter() - t0
        build_log[n] = err
        if p.returncode != 0:
            errors.append(f"nvcc failed for csrc/{n}.cu (rc {p.returncode}):"
                          f"\n{out}{err}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: secs.get(n, 0.0) for n in names}


def load(name: str):
    """The ctypes library of kernel `name`, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build(TOOL_KERNELS if name in TOOL_KERNELS else KERNELS)
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.sw_error_string.argtypes = [ctypes.c_int]
        lib.sw_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib
