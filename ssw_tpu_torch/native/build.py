"""Build + ctypes loader for the native host library (libsswtpu.so).

Compiled lazily on first use with g++ (baked into the image); every consumer
falls back to the pure-Python implementations when the toolchain or zlib is
unavailable, so the native tier is a pure acceleration.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "build", "libsswtpu.so")
_SOURCES = ["traceback.cpp", "fastio.cpp"]

_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= newest:
        return True
    # compile to a unique temp path and os.replace so concurrent processes
    # never dlopen a half-written .so
    tmp = _LIB_PATH + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-pthread", "-o", tmp, *srcs, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load():
    """Return the ctypes library or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _compile():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        c = ctypes
        lib.sswtpu_banded_cigar.restype = c.c_int32
        lib.sswtpu_banded_cigar.argtypes = [
            c.c_void_p, c.c_int32, c.c_void_p, c.c_int32, c.c_int32,
            c.c_int32, c.c_int32, c.c_void_p, c.c_int32, c.c_void_p,
            c.c_int32]
        lib.sswtpu_banded_cigar_batch.restype = None
        lib.sswtpu_banded_cigar_batch.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,
            c.c_void_p, c.c_void_p, c.c_int32, c.c_int32, c.c_int32,
            c.c_void_p, c.c_int32, c.c_void_p, c.c_int64, c.c_void_p]
        lib.sswtpu_fastx_open.restype = c.c_void_p
        lib.sswtpu_fastx_open.argtypes = [c.c_char_p]
        lib.sswtpu_fastx_batch.restype = c.c_int64
        lib.sswtpu_fastx_batch.argtypes = [c.c_void_p, c.c_int64]
        lib.sswtpu_fastx_arena.restype = c.c_void_p
        lib.sswtpu_fastx_arena.argtypes = [c.c_void_p]
        lib.sswtpu_fastx_arena_size.restype = c.c_int64
        lib.sswtpu_fastx_arena_size.argtypes = [c.c_void_p]
        lib.sswtpu_fastx_offsets.restype = c.c_void_p
        lib.sswtpu_fastx_offsets.argtypes = [c.c_void_p]
        lib.sswtpu_fastx_close.restype = None
        lib.sswtpu_fastx_close.argtypes = [c.c_void_p]
        _lib = lib
        return _lib
