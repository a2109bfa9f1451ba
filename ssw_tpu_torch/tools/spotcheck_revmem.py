"""Peak device memory and wall of the begin-finding reverse pass at a
long-read, wide-window shape: the counterpart of the JAX package's
tools/spotcheck_revmem.py.

pipeline._reverse_core at (B, L, W) from argv (default 256 1024 8192, the
JAX tool's; chip_smoke.py runs 2048 1024 8192) on the JAX tool's inputs:
seed 0, a random target of 2^20 codes, random reads of L codes ending at
L - 1, windows ending at random columns >= W, and score1 = 10**6, so that
no read terminates early (the worst case).  At L = 1024 the per-read
kernel runs its largest template, K = L / 32 = 32 rows per lane
(csrc/sw_wave_perread.cu, SW_DISPATCH_K).

It prints one dict: the shape, the peak device memory of the call
(torch.cuda.reset_peak_memory_stats before, max_memory_allocated after),
the process's peak before it and the bytes in use when it starts (its
inputs and whatever the process holds), the card's total memory
(torch.cuda.mem_get_info), the wall (ending in a synchronize) and the
bytes of the call's large transients.  The JAX package chunked the reads
of its Pallas reverse pass and gathered an int8 profile slab per chunk
(its keys "chunks" and "slab_bytes_per_chunk"); the port does not chunk:
one launch takes the whole batch, and what takes the slab's place is the
(B, W) reversed windows (int32, with their int64 gather index), the
(B, L) reversed reads (int8, with their int64 gather index), the
(B, n + 1, L) int8 profile and the kernel's per-read scratch
(cuda_sw._scratch: none where the K rows stay in registers).  With the
kernel library built in this process, the ptxas registers and spill bytes
of its K = 32 entries are printed too.

    python -m ssw_tpu_torch.tools.spotcheck_revmem [B L W] [--device cpu]

On the card unless --device cpu (the plain version; slow at this size).
"""

from __future__ import annotations

import re
import sys
import time

import numpy as np

from ssw_tpu_torch.tools import _common

N = 4           # DNA codes; N is the virtual letter
TARGET = 1 << 20


def workload(B, L, W, device=None) -> dict:
    """The JAX tool's inputs on `device`: _reverse_core's arguments."""
    import torch

    from ssw_tpu_torch import pipeline
    from ssw_tpu_torch.ops import common

    dev = pipeline.resolve_device(device)
    rng = np.random.default_rng(0)
    mat = np.array([[2 if i == j else -2 for j in range(N + 1)]
                    for i in range(N + 1)], np.int8)
    mat[N, :] = 0
    mat[:, N] = 0
    ref = rng.integers(0, N, TARGET, dtype=np.int8)
    Rp = common.bucket_size(len(ref), 256)
    reads = rng.integers(0, N, (B, L), dtype=np.int8)
    er = rng.integers(W, len(ref) - 1, B).astype(np.int32)
    ed = np.full(B, L - 1, np.int32)
    score1 = np.full(B, 10 ** 6, np.int32)  # no early terminate: worst case
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(dev)
    return {"reads_d": t(reads), "er": t(er), "ed": t(ed),
            "score1": t(score1),
            "ref_dev": pipeline._device_ref(ref, N, Rp, dev),
            "mat_ext_d": t(common.extend_matrix(mat)).to(torch.int8),
            "L": L, "W": W, "n": N, "gapO": 3, "gapE": 1, "quirk": False,
            "tier_word": True}


def reverse(inp: dict, rows=None):
    """pipeline._reverse_core on the inputs (their first `rows` reads):
    (3, B) int32, score, end_ref, end_read."""
    from ssw_tpu_torch import pipeline

    cut = slice(None) if rows is None else slice(0, rows)
    return pipeline._reverse_core(
        inp["reads_d"][cut].contiguous(), inp["er"][cut].contiguous(),
        inp["ed"][cut].contiguous(), inp["score1"][cut].contiguous(),
        inp["ref_dev"], inp["mat_ext_d"], L=inp["L"], W=inp["W"],
        n=inp["n"], gapO=inp["gapO"], gapE=inp["gapE"], quirk=inp["quirk"],
        tier_word=inp["tier_word"])


def transient_bytes(B, L, W, dev) -> dict:
    """Bytes of the reverse pass's large transients at (B, L, W)."""
    out = {"reversed_windows": 4 * B * W, "window_index": 8 * B * W,
           "reversed_reads": B * L, "read_index": 8 * B * L,
           "profile": B * (N + 1) * L, "kernel_scratch": None}
    if dev.type == "cuda":
        from ssw_tpu_torch.ops import _kernels

        lib = _kernels.load("sw_wave_perread")
        out["kernel_scratch"] = 4 * B * lib.sw_wave_perread_scratch_per_read(L)
    return out


def ptxas_entries(lib: str, K: int) -> dict:
    """{entry: {"registers", "spill_stores", "spill_loads"}} of the entries
    of kernel library `lib` whose first template argument is K, from its
    ptxas -v log in this process ({} when it was not built here)."""
    from ssw_tpu_torch.ops import _kernels

    out, cur = {}, None
    for line in _kernels.build_log.get(lib, "").splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or f"ILi{K}E" not in cur:
            continue
        row = out.setdefault(cur, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"], row["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    return out


def run(B=256, L=1024, W=8192, device=None):
    """One _reverse_core call at (B, L, W); returns (the dict, the inputs,
    the (3, B) output)."""
    import torch

    from ssw_tpu_torch import pipeline

    dev = pipeline.resolve_device(device)
    inp = workload(B, L, W, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        peak_before = torch.cuda.max_memory_allocated(dev)
        in_use_before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = reverse(inp)
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    res = {"B": B, "L": L, "W": W,
           "transient_bytes": transient_bytes(B, L, W, dev),
           "peak_bytes_in_use": (torch.cuda.max_memory_allocated(dev)
                                 if cuda else None),
           "peak_before": peak_before if cuda else None,
           "in_use_before": in_use_before if cuda else None,
           "bytes_limit": torch.cuda.mem_get_info(dev)[1] if cuda else None,
           "wall_s": wall, "device": str(dev)}
    if cuda:
        res["ptxas_k"] = ptxas_entries("sw_wave_perread", L // 32)
    print(res, flush=True)
    return res, inp, out


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = _common.device_of(argv) or device
    B, L, W = (int(x) for x in argv[:3]) if len(argv) > 2 else (
        256, 1024, 8192)
    run(B, L, W, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
