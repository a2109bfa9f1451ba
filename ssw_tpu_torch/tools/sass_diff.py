"""Compare the SASS of the kernel libraries with another tree's.

Builds the kernel sources of another checkout's csrc/ (for example the
parent commit's, unpacked with `git archive`) into
ssw_tpu_torch/build/sass_diff/, builds this tree's as usual, and compares
every kernel that both libraries have by its `cuobjdump -sass` text (the
anonymous-namespace hash in the names set aside) and its ptxas registers,
for the main path's libraries and the tools'.  A library the other tree
has no source for is listed as new.  A change that claims to leave the
existing kernels alone shows zero differences here.

    python -m ssw_tpu_torch.tools.sass_diff OTHER/ssw_tpu_torch/csrc
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

from ssw_tpu_torch.ops import _kernels
from ssw_tpu_torch.tools import _common

OUT = os.path.join(_kernels.BUILD, "sass_diff")


def _norm(name: str) -> str:
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}",
                  r"ANON_\1", name)


def _sass(path: str) -> dict:
    cuobj = os.path.join(os.path.dirname(_kernels.nvcc_path()), "cuobjdump")
    txt = subprocess.run([cuobj, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(_norm(m.group(1)), [])
        elif cur is not None:
            cur.append(_norm(line))
    return funcs


def _registers(log: str) -> dict:
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _norm(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = int(m.group(1))
            cur = None
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        raise SystemExit("usage: python -m ssw_tpu_torch.tools.sass_diff "
                         "OTHER/ssw_tpu_torch/csrc")
    other = argv[0]
    os.makedirs(OUT, exist_ok=True)
    names = _kernels.KERNELS + _kernels.TOOL_KERNELS
    shared = [n for n in names
              if os.path.exists(os.path.join(other, f"{n}.cu"))]
    procs = {n: subprocess.Popen(
        [_kernels.nvcc_path(), _kernels.ARCH, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         os.path.join(OUT, f"lib{n}.so"), os.path.join(other, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in shared}
    for n in names:  # this tree's, built afresh for its log
        if os.path.exists(_kernels._lib_path(n)):
            os.unlink(_kernels._lib_path(n))
    _kernels.build(names)
    print(f"nvidia-smi: {_common.card_line()}")
    for n in names:
        if n not in shared:
            print(json.dumps({"library": n, "new": True,
                              "kernels": len(_sass(_kernels._lib_path(n)))}),
                  flush=True)
    for n, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {other}/{n}.cu:\n{err}")
        a, b = _sass(os.path.join(OUT, f"lib{n}.so")), \
            _sass(_kernels._lib_path(n))
        ra, rb = _registers(err), _registers(_kernels.build_log[n])
        both = sorted(set(a) & set(b))
        print(json.dumps({
            "library": n, "other_kernels": len(a), "kernels": len(b),
            "compared": len(both),
            "sass_differs": sum(a[k] != b[k] for k in both),
            "registers_differ": sum(ra.get(k) != rb.get(k) for k in both),
            "only_in_other": len(set(a) - set(b)),
            "only_here": len(set(b) - set(a))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
