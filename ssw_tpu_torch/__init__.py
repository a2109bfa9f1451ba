"""ssw_tpu_torch — the striped Smith-Waterman engine on PyTorch and CUDA.

A port of the JAX package `ssw_tpu` (kept in the repository as the frozen
reference) to one NVIDIA H100.  It imports neither JAX nor anything of
`ssw_tpu`: the host modules it shares in spirit are its own copies.

Layers:
  core/      encodings, substitution matrices, CIGAR codec, numpy oracle
  ops/       plain PyTorch DP (scan_sw), CUDA kernel wrappers (cuda_sw),
             kernel build/load (_kernels), host banded traceback (banded)
  csrc/      the hand-written CUDA kernels (sm_90a)
  native/    host C++ traceback and FASTX reader (g++ at first use)
  io/        FASTA/FASTQ reader, SAM + BLAST-like writers
  pipeline   ssw_align-equivalent orchestration (forward -> reverse -> CIGAR)
  api        Profile/Aligner/Filter/Alignment public API (ref: src/ssw.h,
             src/ssw_cpp.h)
  ssw_lib    the reference's ctypes `ssw_lib.py` surface (CSsw)
  cli        `ssw_test`-compatible command line driver (ref: src/main.c)
  pyssw      `pyssw.py`-compatible command line driver
  bridge     JSON-lines worker behind bindings/c and bindings/java
  dcli       the scale-out CLI over hosts and cards
  bench      the GCUPS line of the root bench.py (python -m ssw_tpu_torch.bench)

Entry points run on the CUDA device unless the caller passes device="cpu".
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy: api pulls in the pipeline and torch
    if name in ("Aligner", "Alignment", "Filter", "Profile", "align",
                "align_batch"):
        from ssw_tpu_torch import api
        return getattr(api, name)
    raise AttributeError(name)
