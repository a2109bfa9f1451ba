"""Language-neutral alignment bridge: JSON-lines over stdin/stdout.

The reference exposes the C kernel to other languages through per-language
FFI shims (JNI — ref: src/sswjni.c:36-60; ctypes — ref: src/ssw_lib.py:94).
A device-resident engine can't be dlopen'ed into a JVM, so the equivalent
here is a worker process speaking a line protocol; bindings/java contains
the `ssw.Aligner` client with the reference's exact public API, bindings/c
the C one.  This is the PyTorch/CUDA counterpart of the JAX package's
bridge.py, with the same protocol byte for byte.

    python -m ssw_tpu_torch.bridge

The worker runs on the CUDA card.  SSW_TPU_BRIDGE_PLATFORM, the variable
the clients and their tests already set for the JAX worker, picks the
device: unset, "cuda" or "gpu" the card, "cpu" the plain PyTorch versions;
any other value is an error.  The device is resolved, and on the card every
main-path kernel library built and loaded, before the first line is read:
a worker without a card, or whose kernels fail to build, exits non-zero
without answering, rather than turning each request into an error line.

The C client execs `<python> -m ssw_tpu.bridge`, and the Java client
`<ssw.python> -m ssw_tpu.bridge`; `write_launcher` writes a script to give
them as that python, which ignores its arguments and starts this worker.

Protocol (one JSON object per line):

  request:  {"id": 0, "read": [codes], "ref": [codes],
             "matrix": [n*n flattened], "n": n,
             "gap_open": 3, "gap_extend": 1, "flag": 1,
             "filter_score": 0, "filter_distance": 0, "mask_len": 15,
             "score_size": 2}
            {"id": 1, "batch": [request, ...]}        # batched form
            {"op": "shutdown"}
  response: {"id": 0, "result": {"score1": ..., "score2": ...,
             "ref_begin1": ..., "ref_end1": ..., "read_begin1": ...,
             "read_end1": ..., "ref_end2": ..., "flag": ...,
             "cigar": [bam ints], "cigar_string": "..."}}
            result is null where the C API returns NULL.
"""

from __future__ import annotations

import json
import os
import shlex
import sys

import numpy as np

from ssw_tpu_torch import api, pipeline
from ssw_tpu_torch.core.cigar import cigar_int_to_len, cigar_int_to_op
from ssw_tpu_torch.ops import _kernels

PLATFORM_ENV = "SSW_TPU_BRIDGE_PLATFORM"
_PLATFORMS = {"": None, "cuda": None, "gpu": None, "cpu": "cpu"}


def env_device():
    """The worker's device from SSW_TPU_BRIDGE_PLATFORM: None (the card)
    when unset, "cuda" or "gpu"; "cpu" for "cpu"; anything else raises."""
    value = os.environ.get(PLATFORM_ENV, "")
    if value not in _PLATFORMS:
        raise ValueError(f"{PLATFORM_ENV}={value!r}: expected cuda, gpu or "
                         f"cpu")
    return _PLATFORMS[value]


def start(device=None):
    """Resolve the worker's device (None: the card, raising when there is
    none) and, on the card, build and load every main-path kernel library,
    so that a fault shows before any request is answered."""
    device = pipeline.resolve_device(device)
    if device.type == "cuda":
        for name in _kernels.KERNELS:
            _kernels.load(name)
    return device


def write_launcher(path):
    """Write an executable shell script at `path` that ignores its
    arguments, enters the directory that holds this package and execs
    this interpreter with `-m ssw_tpu_torch.bridge`: the C and Java
    clients run it in place of their python."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\ncd {shlex.quote(root)} || exit 127\n"
                f"exec {shlex.quote(sys.executable)} -m ssw_tpu_torch.bridge"
                f"\n")
    os.chmod(path, 0o755)
    return path


def _dumps(obj) -> str:
    """Compact JSON: the Java client's hand-rolled intField parser scans
    digits immediately after '\"name\":' (bindings/java/ssw/Aligner.java),
    so the wire format must not carry a space after the colon."""
    return json.dumps(obj, separators=(",", ":"))


def _align_one(msg, device):
    n = int(msg["n"])
    mat = np.asarray(msg["matrix"], dtype=np.int8).reshape(n, n)
    r = api.align(
        np.asarray(msg["read"], dtype=np.int32),
        np.asarray(msg["ref"], dtype=np.int32),
        int(msg["gap_open"]), int(msg["gap_extend"]), mat=mat,
        flag=int(msg.get("flag", 0x0F)),
        filters=int(msg.get("filter_score", 0)),
        filterd=(2 ** 31 - 1 if msg.get("filter_distance") is None
                 else int(msg["filter_distance"])),
        mask_len=int(msg.get("mask_len", 15)),
        score_size=int(msg.get("score_size", 2)), device=device)
    return _result_dict(r)


def _result_dict(r):
    if r is None:
        return None
    cigar = [int(c) for c in (r.cigar or [])]
    return {
        "score1": r.score1, "score2": r.score2,
        "ref_begin1": r.ref_begin1, "ref_end1": r.ref_end1,
        "read_begin1": r.read_begin1, "read_end1": r.read_end1,
        "ref_end2": r.ref_end2, "flag": r.flag, "cigar": cigar,
        "cigar_string": "".join(
            f"{cigar_int_to_len(c)}{cigar_int_to_op(c)}" for c in cigar),
    }


def _align_many(msgs, device):
    """Batched form: requests sharing (ref, matrix, penalties, flags) run
    as ONE device batch through api.align_batch — this is the wire form
    the Java binding's alignBatch uses; mixed-config batches split into
    per-config groups."""
    results = [None] * len(msgs)
    groups: dict = {}
    for i, m in enumerate(msgs):
        key = (tuple(m["ref"]), tuple(m["matrix"]), int(m["n"]),
               int(m["gap_open"]), int(m["gap_extend"]),
               int(m.get("flag", 0x0F)), int(m.get("filter_score", 0)),
               (2 ** 31 - 1 if m.get("filter_distance") is None
                else int(m["filter_distance"])),
               int(m.get("score_size", 2)))
        groups.setdefault(key, []).append(i)
    for key, idxs in groups.items():
        (ref, mat_flat, n, gapO, gapE, flag, filters, filterd,
         score_size) = key
        mat = np.asarray(mat_flat, dtype=np.int8).reshape(n, n)
        reads = [np.asarray(msgs[i]["read"], dtype=np.int32) for i in idxs]
        mask = [int(msgs[i].get("mask_len", 15)) for i in idxs]
        rs = api.align_batch(
            reads, np.asarray(ref, dtype=np.int32), mat, gapO, gapE,
            flag=flag, filters=filters, filterd=filterd, mask_len=mask,
            score_size=score_size, device=device)
        for i, r in zip(idxs, rs):
            results[i] = _result_dict(r)
    return results


def serve(inp=None, out=None, device=None) -> int:
    """Answer request lines from `inp` on `out` until shutdown or end of
    input, on `device` (see start), resolved before the first line."""
    device = start(device)
    inp = inp or sys.stdin
    out = out or sys.stdout
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError:
            out.write(_dumps({"error": "bad json"}) + "\n")
            out.flush()
            continue
        if msg.get("op") == "shutdown":
            return 0
        try:
            if "batch" in msg:
                result = _align_many(msg["batch"], device)
            else:
                result = _align_one(msg, device)
            out.write(_dumps({"id": msg.get("id"), "result": result}) + "\n")
        except Exception as e:  # surface errors to the client, keep serving
            out.write(_dumps({"id": msg.get("id"), "error": str(e)}) + "\n")
        out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(serve(device=env_device()))
